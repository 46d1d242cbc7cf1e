"""Build, load and launch the block-streaming BSR kernel K6
(csrc/bsr_spmm.cu, ``bsr_block_spmm``).

Built and bound through :mod:`tpuspmm_torch.kernels.cuda_build`.  Nothing
here runs when the module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from tpuspmm_torch.kernels import cuda_build

ENTRY = "bsr_block_spmm"
# the source's tiles: output columns per block, block columns per staged
# step, and output rows per block (32 when it divides bh, else 8)
COLUMN_TILE = 64
K_CHUNK = 32


def row_tile(bh: int) -> int:
    return 32 if bh % 32 == 0 else 8


def smem_bytes(bh: int) -> int:
    """Static shared memory of one block: the staged block and B slices."""
    return (K_CHUNK * (row_tile(bh) + 1) + K_CHUNK * COLUMN_TILE) * 4


def _bind(lib) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.bsr_spmm_error_string.argtypes = [ctypes.c_int]
    lib.bsr_spmm_error_string.restype = ctypes.c_char_p


LIBRARY = cuda_build.CudaLibrary("bsr_spmm.cu", _bind)
SOURCE = LIBRARY.source
build = LIBRARY.build
load = LIBRARY.load


def block_spmm(indptr: torch.Tensor, indices: torch.Tensor,
               blocks: torch.Tensor, b: torch.Tensor, m: int) -> torch.Tensor:
    """Launch K6 on the current stream: C (m, n) f32 from the BSR arrays
    (indptr, indices int32; blocks (nblocks, bh, bw) f32; on b's device)
    and a contiguous (k, n) f32 or bf16 B.  Raises on what the kernel does
    not take and on a refused launch."""
    from tpuspmm_torch.kernels.csr_vmem import smem_optin

    if b.device.type != "cuda":
        raise ValueError(f"{ENTRY}: b must be a CUDA tensor, got {b.device}")
    if (b.dim() != 2 or b.dtype not in (torch.float32, torch.bfloat16)
            or not b.is_contiguous()):
        raise ValueError(f"{ENTRY}: b must be a contiguous 2-D f32/bf16 "
                         f"tensor, got {tuple(b.shape)} {b.dtype}")
    for name, t, want in (("indptr", indptr, torch.int32),
                          ("indices", indices, torch.int32),
                          ("blocks", blocks, torch.float32)):
        if t.device != b.device or not t.is_contiguous() or t.dtype != want:
            raise ValueError(f"{ENTRY}: {name} must be a contiguous {want} "
                             f"tensor on {b.device}")
    if blocks.dim() != 3 or blocks.shape[0] != indices.numel():
        raise ValueError(f"{ENTRY}: blocks must be (nblocks, bh, bw), "
                         f"got {tuple(blocks.shape)}")
    _, bh, bw = (int(s) for s in blocks.shape)
    if bh % 8 or bw % K_CHUNK:
        raise ValueError(f"{ENTRY}: block ({bh}, {bw}) needs bh % 8 == 0 "
                         f"and bw % {K_CHUNK} == 0")
    num_block_rows = indptr.numel() - 1
    if num_block_rows * bh < m:
        raise ValueError(f"{ENTRY}: {num_block_rows} block rows of {bh} "
                         f"cover fewer than m={m} rows")
    if smem_bytes(bh) > smem_optin(b.device):
        raise ValueError(f"{ENTRY}: {smem_bytes(bh)} bytes of shared "
                         "memory exceed the card's opt-in limit")
    k, n = (int(s) for s in b.shape)
    lib = load()
    # the ctypes launch goes to the current device: make it b's
    with torch.cuda.device(b.device):
        out = torch.empty((m, n), dtype=torch.float32, device=b.device)
        rc = getattr(lib, ENTRY)(
            indptr.data_ptr(), indices.data_ptr(), blocks.data_ptr(),
            b.data_ptr(), int(b.dtype == torch.bfloat16), out.data_ptr(),
            num_block_rows, m, k, n, bh, bw,
            torch.cuda.current_stream(b.device).cuda_stream)
    cuda_build.check_launch(lib, "bsr_spmm_error_string", ENTRY, rc)
    return out
