"""Build, load and launch the tile-owner CUDA routine (csrc/chunk_spmm.cu):
the tile-plan kernels K3 (tile), K4 (staged), K5a and K5b (C-resident),
one C entry (``tile_owner_spmm``) over one tile index
(:func:`tpuspmm_torch.kernels.tile_spmm.build_tile_index`); each Python
entry passes its own name, for messages.

Built and bound through :mod:`tpuspmm_torch.kernels.cuda_build`.  Nothing
here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuspmm_torch.kernels import cuda_build

# the routine's geometry, compiled into the source (WARP_ROWS, MAX_ROWS,
# NARROW_TN / WIDE_TN, KC there; a CPU test holds them equal): output rows
# of a warp, of a block at most, the two column tiles, and the k-chunk a
# dense tile is staged in, which tile_k must be a multiple of for a tile to
# take the dense path
WARP_ROWS = 16
MAX_ROWS = 128
COLUMN_TILES = (64, 128)
KC = 32
# the tile index's device arrays, in the order of the C interface
INDEX = ("row_ptr", "g_col", "g_val", "d_ptr", "d_kt", "d_a", "order")


def _bind(lib) -> None:
    lib.tile_owner_spmm.argtypes = (
        [ctypes.c_void_p] * (len(INDEX) + 1) + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.tile_owner_spmm.restype = ctypes.c_int
    lib.chunk_spmm_blocks_per_sm.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.chunk_spmm_blocks_per_sm.restype = ctypes.c_int
    lib.chunk_spmm_error_string.argtypes = [ctypes.c_int]
    lib.chunk_spmm_error_string.restype = ctypes.c_char_p


LIBRARY = cuda_build.CudaLibrary("chunk_spmm.cu", _bind)
SOURCE = LIBRARY.source
build = LIBRARY.build
load = LIBRARY.load


def check_shape(tm: int) -> None:
    """Refuse a plan the routine cannot run, before any launch: a block's
    ceil(tm / WARP_ROWS) warps own the row tile, at most MAX_ROWS rows."""
    if not 0 < tm <= MAX_ROWS:
        raise ValueError(f"tile_m={tm}: the tile-owner routine runs row "
                         f"tiles of 1 to {MAX_ROWS} rows")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(entry: str, idx: dict, b: torch.Tensor, m: int, tm: int,
           tk: int, split2: bool) -> torch.Tensor:
    """Launch the routine on the current stream for the entry named
    ``entry``: C (m, n) f32 from the tile index ``idx`` (:data:`INDEX`, on
    b's device), at the 2-term tier when ``split2``.  Raises on what the
    kernel does not take and on a refused launch."""
    check_shape(tm)
    if b.device.type != "cuda":
        raise ValueError(f"{entry}: b must be a CUDA tensor, got {b.device}")
    if (b.dim() != 2 or b.dtype not in (torch.float32, torch.bfloat16)
            or not b.is_contiguous()):
        raise ValueError(f"{entry}: b must be a contiguous 2-D f32/bf16 "
                         f"tensor, got {tuple(b.shape)} {b.dtype}")
    for name in INDEX:
        t = idx[name]
        want = torch.float32 if name in ("g_val", "d_a") else torch.int32
        if t.device != b.device or not t.is_contiguous() or t.dtype != want:
            raise ValueError(f"{entry}: {name} must be a contiguous {want} "
                             f"tensor on {b.device}")
    num_tiles = idx["order"].numel()
    n_dense = idx["d_kt"].numel()
    if (num_tiles != -(-m // tm) or idx["row_ptr"].numel() != num_tiles * tm
            + 1 or idx["d_ptr"].numel() != num_tiles + 1):
        raise ValueError(f"{entry}: the index is not over {-(-m // tm)} row "
                         f"tiles of {tm} rows")
    if n_dense and (split2 or tk % KC or tuple(idx["d_a"].shape) != (
            n_dense, -(-tm // WARP_ROWS) * WARP_ROWS, tk)):
        raise ValueError(f"{entry}: dense tiles need tile_k % {KC} == 0, "
                         "no split2, and (tiles, round_up(tm, 16), tk) A")
    lib = load()
    k, n = b.shape
    # the ctypes launch goes to the current device: make it b's
    with torch.cuda.device(b.device):
        out = torch.empty((m, n), dtype=torch.float32, device=b.device)
        rc = lib.tile_owner_spmm(
            *(idx[name].data_ptr() for name in INDEX), b.data_ptr(),
            int(b.dtype == torch.bfloat16), out.data_ptr(), num_tiles, m, k,
            n, tm, tk, n_dense, int(split2), _sm_count(b.device),
            torch.cuda.current_stream(b.device).cuda_stream)
    cuda_build.check_launch(lib, "chunk_spmm_error_string", entry, rc)
    return out


def blocks_per_sm(b_bf16: bool, wide: bool, split2: bool) -> int:
    """Blocks of one instantiation an SM holds at once (the occupancy
    calculator on the current device), for a record."""
    lib = load()
    err = ctypes.c_int(0)
    blocks = lib.chunk_spmm_blocks_per_sm(int(b_bf16), int(wide),
                                          int(split2), ctypes.byref(err))
    cuda_build.check_launch(lib, "chunk_spmm_error_string",
                            "chunk_spmm_blocks_per_sm", err.value)
    return blocks
