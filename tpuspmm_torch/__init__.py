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

A host (numpy) B goes to the card unless ``Config(device="cpu")`` asks
for the CPU; a torch tensor B is served on its own device.  A BSR whose
blocks the block-streaming kernel takes (or packs into 128 × 128 blocks)
is served by it::

    W = tpuspmm_torch.BSR.random_blocks(4096, 4096, (128, 128), 0.1)
    C = tpuspmm_torch.spmm(W, B)

``spmm(A, B, method="tuned")`` measures every admissible kernel once per
(matrix, width, B dtype) and serves the fastest that passes the gate;
``spmv``, ``spmm_batched`` (a stack of B in one launch), ``spmm_transpose``
and ``spmm_fn`` (a differentiable ``B -> A @ B``) complete the API.

The engines: ``python -m tpuspmm_torch.cli --csr --coo --bsr --ell -d DIR``,
``--auto`` to run the format the selection picks, ``--tuned`` for the
autotuned winner; the headline: ``python -m tpuspmm_torch.bench``.
"""

from tpuspmm_torch.config import Config, default_config
from tpuspmm_torch.formats import BSR, CSC, CSR, COO, ELL, DenseMatrix
from tpuspmm_torch.ops.api import (spmm, spmv, spmm_batched, spmm_transpose,
                                   spmm_fn)
from tpuspmm_torch.engine.registry import get_engine, FORMATS

__all__ = ["Config", "default_config", "CSR", "CSC", "COO", "BSR", "ELL",
           "DenseMatrix", "spmm", "spmv", "spmm_batched", "spmm_transpose",
           "spmm_fn", "get_engine", "FORMATS"]
