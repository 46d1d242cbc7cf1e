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

The engines: ``python -m tpuspmm_torch.cli --csr --coo --bsr --ell -d DIR``,
or ``--auto`` to run the format the selection picks.
"""

from tpuspmm_torch.config import Config, default_config
from tpuspmm_torch.formats import BSR, CSC, CSR, COO, ELL, DenseMatrix
from tpuspmm_torch.ops.api import spmm

__all__ = ["Config", "default_config", "CSR", "CSC", "COO", "BSR", "ELL",
           "DenseMatrix", "spmm"]
