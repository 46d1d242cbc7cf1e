"""Sparse and dense containers: frozen dataclasses of numpy arrays, with
derived objects and device tensors cached on them."""

from tpuspmm_torch.formats.csr import CSR
from tpuspmm_torch.formats.csc import CSC
from tpuspmm_torch.formats.coo import COO
from tpuspmm_torch.formats.bsr import BSR
from tpuspmm_torch.formats.ell import ELL
from tpuspmm_torch.formats.dense import DenseMatrix
from tpuspmm_torch.formats import convert

__all__ = ["CSR", "CSC", "COO", "BSR", "ELL", "DenseMatrix", "convert"]
