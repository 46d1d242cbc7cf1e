"""Build, load and launch the chunk-owner CUDA kernels (csrc/chunk_spmm.cu):
the tile-plan kernels K3 (tile), K4 (staged), K5a and K5b (C-resident).

Built and bound through :mod:`tpuspmm_torch.kernels.cuda_build`.  Nothing
here runs when the module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from tpuspmm_torch.kernels import cuda_build

# output columns per block of every kernel in the source (TN there)
COLUMN_TILE = 64
WALK_ENTRIES = ("tile_chunk_spmm", "cres_chunk_spmm",
                "cres_kloop_chunk_spmm")
STAGED_ENTRY = "staged_chunk_spmm"


def _bind(lib) -> None:
    # (index arrays, kt, rows, cols, vals, b, b_bf16, out): one index array
    # (tile_ptr) for a walk entry, two (start, end) for the staged entry
    def ptrs(n_index):
        return [ctypes.c_void_p] * (n_index + 5) + [ctypes.c_int,
                                                    ctypes.c_void_p]

    for name in WALK_ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = ptrs(1) + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = getattr(lib, STAGED_ENTRY)
    fn.argtypes = ptrs(2) + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.chunk_spmm_error_string.argtypes = [ctypes.c_int]
    lib.chunk_spmm_error_string.restype = ctypes.c_char_p


LIBRARY = cuda_build.CudaLibrary("chunk_spmm.cu", _bind)
SOURCE = LIBRARY.source
build = LIBRARY.build
load = LIBRARY.load

_INDEX = ("kt", "rows", "cols")


def _check(entry: str, arrs: dict, b: torch.Tensor, names, chunk: int):
    if b.device.type != "cuda":
        raise ValueError(f"{entry}: b must be a CUDA tensor, got {b.device}")
    if (b.dim() != 2 or b.dtype not in (torch.float32, torch.bfloat16)
            or not b.is_contiguous()):
        raise ValueError(f"{entry}: b must be a contiguous 2-D f32/bf16 "
                         f"tensor, got {tuple(b.shape)} {b.dtype}")
    for name in names:
        t = arrs[name]
        want = torch.float32 if name == "vals" else torch.int32
        if t.device != b.device or not t.is_contiguous() or t.dtype != want:
            raise ValueError(f"{entry}: {name} must be a contiguous {want} "
                             f"tensor on {b.device}")
    if arrs["rows"].shape[-1] != chunk or arrs["vals"].shape != \
            arrs["rows"].shape or arrs["cols"].shape != arrs["rows"].shape:
        raise ValueError(f"{entry}: chunk payloads must be (C, {chunk})")


def _launch(entry: str, b: torch.Tensor, m: int, call) -> torch.Tensor:
    lib = load()
    # the ctypes launch goes to the current device: make it b's
    with torch.cuda.device(b.device):
        out = torch.empty((m, b.shape[1]), dtype=torch.float32,
                          device=b.device)
        rc = call(getattr(lib, entry), out,
                  torch.cuda.current_stream(b.device).cuda_stream)
    cuda_build.check_launch(lib, "chunk_spmm_error_string", entry, rc)
    return out


def owner_walk(entry: str, arrs: dict, b: torch.Tensor, m: int, tm: int,
               tk: int, chunk: int, split2: bool) -> torch.Tensor:
    """Launch a walk entry (K3, K5a, K5b) on the current stream: C (m, n)
    f32 from the row-major chunk arrays in ``arrs`` (tile_ptr, row tile
    r's chunks being [tile_ptr[r], tile_ptr[r+1]); kt, rows, cols, vals;
    on b's device).  Raises on what the kernel does not take and on a
    refused launch."""
    if entry not in WALK_ENTRIES:
        raise ValueError(f"unknown walk entry {entry!r}")
    names = ("tile_ptr", *_INDEX, "vals")
    _check(entry, arrs, b, names, chunk)
    num_tiles = arrs["tile_ptr"].numel() - 1
    if num_tiles != -(-m // tm):
        raise ValueError(f"{entry}: tile_ptr has {num_tiles} row tiles "
                         f"for m={m}, tm={tm}")

    def call(fn, out, stream):
        return fn(*(arrs[k].data_ptr() for k in names), b.data_ptr(),
                  int(b.dtype == torch.bfloat16), out.data_ptr(), num_tiles,
                  m, b.shape[1], tm, tk, chunk, int(split2), stream)

    return _launch(entry, b, m, call)


def staged(arrs: dict, b: torch.Tensor, m: int, tm: int, tk: int,
           chunk: int, split2: bool, num_slabs: int,
           slab_k: int) -> torch.Tensor:
    """Launch the staged entry (K4) on the current stream: C (m, n) f32
    from the slab layout in ``arrs`` (start, end per (row tile, slab);
    kt, rows, cols, vals on b's device)."""
    names = ("start", "end", *_INDEX, "vals")
    _check(STAGED_ENTRY, arrs, b, names, chunk)
    num_tiles = -(-m // tm)
    if arrs["start"].numel() != num_tiles * num_slabs or slab_k % tk:
        raise ValueError(f"{STAGED_ENTRY}: {arrs['start'].numel()} ranges "
                         f"for {num_tiles} row tiles x {num_slabs} slabs, "
                         f"slab_k={slab_k}")

    def call(fn, out, stream):
        return fn(*(arrs[k].data_ptr() for k in names), b.data_ptr(),
                  int(b.dtype == torch.bfloat16), out.data_ptr(), num_tiles,
                  m, b.shape[0], b.shape[1], tm, tk, chunk, int(split2),
                  num_slabs, slab_k, stream)

    return _launch(STAGED_ENTRY, b, m, call)
