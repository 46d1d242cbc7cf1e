"""Build, load and launch the block-streaming BSR kernel K6
(csrc/bsr_spmm.cu, ``bsr_block_spmm``: wgmma over bf16 term planes).

Built and bound through :mod:`tpuspmm_torch.kernels.cuda_build`.  Nothing
here runs when the module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from tpuspmm_torch.kernels import cuda_build

ENTRY = "bsr_block_spmm"
# the source's constants (a CPU test holds them equal): block columns a
# step, bf16 term planes of A, the row sub-tiles (the first that divides bh
# is taken) and the output columns of one block.  The ring's depth and its
# shared memory stay in the source: a launch that does not fit is refused
# there, and ``block_spmm`` raises on the code it returns
K_CHUNK = 64
TERMS = 3
ROW_TILES = (128, 32, 8)
COLUMN_TILE = 64


def row_tile(bh: int) -> int:
    """Rows of one owner's sub-tile (wgmma's N) for block height bh."""
    return next(rt for rt in ROW_TILES if bh % rt == 0)


def planes_shape(nblocks: int, bh: int, bw: int) -> tuple:
    """Shape of the term planes the kernel reads (bf16 bits as int16):
    (block, row sub-tile, k-step, term, sub-tile row, 64 block columns)."""
    rt = row_tile(bh)
    return (nblocks, bh // rt, bw // K_CHUNK, TERMS, rt, K_CHUNK)


def vector_staging(b: torch.Tensor) -> bool:
    """Whether B's rows are 16-byte aligned, so the build that stages B by
    16-byte cp.async takes it; else the build with plain loads."""
    return (b.data_ptr() % 16 == 0
            and b.shape[1] * b.element_size() % 16 == 0)


def _bind(lib) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.bsr_spmm_error_string.argtypes = [ctypes.c_int]
    lib.bsr_spmm_error_string.restype = ctypes.c_char_p


LIBRARY = cuda_build.CudaLibrary("bsr_spmm.cu", _bind)
SOURCE = LIBRARY.source
build = LIBRARY.build
load = LIBRARY.load


def block_spmm(indptr: torch.Tensor, indices: torch.Tensor,
               row_order: torch.Tensor, planes: torch.Tensor,
               b: torch.Tensor, m: int, block_size) -> torch.Tensor:
    """Launch K6 on the current stream: C (m, n) f32 from the BSR arrays
    (indptr, indices int32), the block rows most stored blocks first
    (row_order int32), the blocks' term planes (``planes_shape``, int16,
    16-byte aligned; all on b's device) and a contiguous (k, n) f32 or bf16
    B.  Raises on what the kernel does not take and on a refused launch."""
    if b.device.type != "cuda":
        raise ValueError(f"{ENTRY}: b must be a CUDA tensor, got {b.device}")
    if (b.dim() != 2 or b.dtype not in (torch.float32, torch.bfloat16)
            or not b.is_contiguous()):
        raise ValueError(f"{ENTRY}: b must be a contiguous 2-D f32/bf16 "
                         f"tensor, got {tuple(b.shape)} {b.dtype}")
    for name, t, want in (("indptr", indptr, torch.int32),
                          ("indices", indices, torch.int32),
                          ("row_order", row_order, torch.int32),
                          ("planes", planes, torch.int16)):
        if t.device != b.device or not t.is_contiguous() or t.dtype != want:
            raise ValueError(f"{ENTRY}: {name} must be a contiguous {want} "
                             f"tensor on {b.device}")
    bh, bw = (int(s) for s in block_size)
    if bh % 8 or bw % K_CHUNK:
        raise ValueError(f"{ENTRY}: block ({bh}, {bw}) needs bh % 8 == 0 "
                         f"and bw % {K_CHUNK} == 0")
    num_block_rows = indptr.numel() - 1
    if row_order.numel() != num_block_rows:
        raise ValueError(f"{ENTRY}: row_order must list the "
                         f"{num_block_rows} block rows")
    want = planes_shape(indices.numel(), bh, bw)
    if tuple(planes.shape) != want or planes.data_ptr() % 16:
        raise ValueError(f"{ENTRY}: planes must be {want} and 16-byte "
                         f"aligned, got {tuple(planes.shape)}")
    if num_block_rows * bh < m:
        raise ValueError(f"{ENTRY}: {num_block_rows} block rows of {bh} "
                         f"cover fewer than m={m} rows")
    b_bf16 = b.dtype == torch.bfloat16
    k, n = (int(s) for s in b.shape)
    lib = load()
    # the ctypes launch goes to the current device: make it b's
    with torch.cuda.device(b.device):
        out = torch.empty((m, n), dtype=torch.float32, device=b.device)
        rc = getattr(lib, ENTRY)(
            indptr.data_ptr(), indices.data_ptr(), row_order.data_ptr(),
            planes.data_ptr(), b.data_ptr(), int(b_bf16),
            int(vector_staging(b)), out.data_ptr(), num_block_rows, m, k, n,
            bh, bw, torch.cuda.current_stream(b.device).cuda_stream)
    cuda_build.check_launch(lib, "bsr_spmm_error_string", ENTRY, rc)
    return out
