"""tpuspmm_torch — sparse × dense matrix multiplication in PyTorch, with
kernels written by hand in CUDA C++ for NVIDIA Hopper.

The port of ``tpuspmm`` (JAX / Pallas on TPU), which stays beside it as the
reference.  This package imports torch, numpy and scipy, never jax.

Quick start::

    import torch, tpuspmm_torch
    from tpuspmm_torch.formats import convert
    A = convert.load_sparse("data/large_25605", "csr")
    B = torch.rand(A.shape[1], 256, device="cuda") * 2 - 1
    C = tpuspmm_torch.spmm(A, B)   # the dispatcher, in tpuspmm's order

The CSR / COO engine: ``python -m tpuspmm_torch.cli --csr --coo -d DIR``.
"""

from tpuspmm_torch.config import Config, default_config
from tpuspmm_torch.formats import CSR, COO, DenseMatrix
from tpuspmm_torch.ops.api import spmm

__all__ = ["Config", "default_config", "CSR", "COO", "DenseMatrix", "spmm"]
