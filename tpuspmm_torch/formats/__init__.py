"""Sparse and dense containers: frozen dataclasses of numpy arrays, with
derived objects and device tensors cached on them."""

from tpuspmm_torch.formats.csr import CSR
from tpuspmm_torch.formats.coo import COO
from tpuspmm_torch.formats.dense import DenseMatrix
from tpuspmm_torch.formats import convert

__all__ = ["CSR", "COO", "DenseMatrix", "convert"]
