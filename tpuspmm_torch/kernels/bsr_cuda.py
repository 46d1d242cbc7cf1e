"""Build, load and launch the block-streaming BSR kernel K6
(csrc/bsr_spmm.cu, ``bsr_block_spmm``: wgmma over bf16 term planes).

Built and bound through :mod:`tpuspmm_torch.kernels.cuda_build`.  Nothing
here runs when the module is imported.  The launch shape is decided here,
once a binding, and passed to the C entry, which checks it and launches
it: the build (``warp_specialised``: a bf16 B with 16-byte aligned rows
takes the warp-specialised build), its consumer warpgroups
(``ws_consumers``) and its grid (``ws_grid``).  The binding records what
it passes (``Launch.shape``).
"""

from __future__ import annotations

import ctypes
import sys

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
# the warp-specialised build's, as in the source: producer and consumer
# warpgroups at most (each consumer on COLUMN_TILE columns) and its ring's
# stages at most; then its launch rules' own, which only this module
# holds: the waves of two-consumer blocks a grid must fill to take them
# (``ws_consumers``) and of 128-row tiles that make its grid persistent
# (``ws_grid``)
PRODUCER_WARPGROUPS = 1
CONSUMER_WARPGROUPS = 2
WS_STAGES = 4
WS_WAVES = 2
PERSIST_WAVES = 3


def row_tile(bh: int) -> int:
    """Rows of one owner's sub-tile (wgmma's N) for block height bh."""
    return next(rt for rt in ROW_TILES if bh % rt == 0)


def planes_shape(nblocks: int, bh: int, bw: int) -> tuple:
    """Shape of the term planes the kernel reads (bf16 bits as int16):
    (block, row sub-tile, k-step, term, sub-tile row, 64 block columns)."""
    rt = row_tile(bh)
    return (nblocks, bh // rt, bw // K_CHUNK, TERMS, rt, K_CHUNK)


def warp_specialised(dtype, n: int, aligned: bool = True) -> bool:
    """Whether K6 serves a B of this dtype and width n by the
    warp-specialised build: bf16 with 16-byte aligned rows (n % 8 == 0 and
    its data ``aligned``); f32 B and unaligned bf16 B keep the register
    builds."""
    return dtype == torch.bfloat16 and aligned and n * 2 % 16 == 0


def ws_consumers(units: int, n: int, sms: int) -> int:
    """Consumer warpgroups of the warp-specialised build for ``units`` row
    sub-tiles, B of width n and ``sms`` SMs: two, on a 2·COLUMN_TILE-column
    tile, where B is wider than one tile and those tiles fill the SMs
    WS_WAVES times; else one, which halves a heavy block row's products a
    step."""
    wide = COLUMN_TILE * CONSUMER_WARPGROUPS
    if n > COLUMN_TILE and units * -(-n // wide) >= WS_WAVES * sms:
        return CONSUMER_WARPGROUPS
    return 1


def ws_tiles(units: int, n: int, sms: int) -> int:
    """Tiles of the warp-specialised build for ``units`` row sub-tiles and
    B of width n on ``sms`` SMs: units x column tiles of ``ws_consumers``
    x COLUMN_TILE columns (as the source's ``launch_ws_c`` counts them)."""
    return units * -(-n // (COLUMN_TILE * ws_consumers(units, n, sms)))


def ws_grid(units: int, n: int, sms: int, rt: int) -> int:
    """Blocks of the warp-specialised build's grid: at 128-row sub-tiles
    (``rt``), min(tiles, sms) where the tiles fill the SMs PERSIST_WAVES
    times, each block walking tiles; else one block a tile."""
    tiles = ws_tiles(units, n, sms)
    if rt == ROW_TILES[0] and tiles >= PERSIST_WAVES * sms:
        return min(tiles, sms)
    return tiles


def ws_schedule(units: int, n: int, sms: int, rt: int) -> list:
    """Each block's tiles in the order it walks them, as (unit, column
    tile), units in ``row_order``'s order and column tile fastest: block c
    takes one tile of each round of ``grid`` consecutive tiles, the c-th on
    even rounds and the c-th from the end on odd ones (the source's
    ``ws_tile_index``)."""
    tiles, grid = ws_tiles(units, n, sms), ws_grid(units, n, sms, rt)
    ncol = tiles // units if units else 0
    walks = []
    for c in range(grid):
        xs = [base + (grid - 1 - c if r % 2 else c)
              for r, base in enumerate(range(0, tiles, grid))]
        walks.append([divmod(x, ncol) for x in xs if x < tiles])
    return walks


def vector_staging(b: torch.Tensor) -> bool:
    """Whether B's rows are 16-byte aligned, so the build that stages B by
    16-byte cp.async takes it; else the build with plain loads."""
    return (b.data_ptr() % 16 == 0
            and b.shape[1] * b.element_size() % 16 == 0)


def _bind(lib) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.bsr_spmm_error_string.argtypes = [ctypes.c_int]
    lib.bsr_spmm_error_string.restype = ctypes.c_char_p


LIBRARY = cuda_build.CudaLibrary("bsr_spmm.cu", _bind)
SOURCE = LIBRARY.source
build = LIBRARY.build
load = LIBRARY.load


def _checked(indptr: torch.Tensor, indices: torch.Tensor,
             row_order: torch.Tensor, planes: torch.Tensor, b: torch.Tensor,
             m: int, block_size) -> tuple:
    """Refuse what K6 does not take, before any launch: B (as
    ``cuda_build.check_b``) and the BSR arrays' device, dtype,
    contiguity, shape and alignment; (block rows, bh, bw)."""
    cuda_build.check_b(ENTRY, b)
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
    return num_block_rows, bh, bw


def launch_shape(b: torch.Tensor, num_block_rows: int, bh: int) -> dict:
    """What a binding for B of b's shape and dtype launches on b's device:
    the build, and for the warp-specialised build its consumer warpgroups
    (``ws_consumers``), its grid (``ws_grid``) and its tiles
    (``ws_tiles``); 0 for each where the register builds take B."""
    n = int(b.shape[1])
    if not warp_specialised(b.dtype, n):
        return {"build": "register", "consumers": 0, "grid": 0, "tiles": 0}
    rt = row_tile(bh)
    units = num_block_rows * (bh // rt)
    sms = cuda_build.sm_count(b.device)
    return {"build": "warp_specialised",
            "consumers": ws_consumers(units, n, sms),
            "grid": ws_grid(units, n, sms, rt),
            "tiles": ws_tiles(units, n, sms)}


def bind(indptr: torch.Tensor, indices: torch.Tensor,
         row_order: torch.Tensor, planes: torch.Tensor, b: torch.Tensor,
         m: int, block_size, counter=None) -> cuda_build.Launch:
    """K6's launch bound to the BSR arrays (indptr, indices int32), the
    block rows most stored blocks first (row_order int32) and the blocks'
    term planes (``planes_shape``, int16, 16-byte aligned; all on b's
    device) for B of b's shape, dtype and device: C (m, n) f32;
    ``counter.launches`` counts its launches.  Checks the arrays once,
    here, and raises on what the kernel does not take.  The launch shape
    (:func:`launch_shape`) is decided here and kept as the launch's
    ``shape``; a call whose B data is not 16-byte aligned stages B by
    plain loads (``vector_staging``), which with bf16 B is the register
    build: it passes 0 consumers."""
    num_block_rows, bh, bw = _checked(indptr, indices, row_order, planes, b,
                                      m, block_size)
    k, n = (int(s) for s in b.shape)
    keep = (indptr, indices, row_order, planes)
    head = tuple(t.data_ptr() for t in keep)
    b_bf16 = int(b.dtype == torch.bfloat16)
    rows_aligned = n * b.element_size() % 16 == 0
    shape = launch_shape(b, num_block_rows, bh)
    consumers, grid = shape["consumers"], shape["grid"]
    tail = (num_block_rows, m, k, n, bh, bw)

    def args(b_ptr, out_ptr, stream):
        vector = int(rows_aligned and b_ptr % 16 == 0)  # vector_staging(b)
        return (*head, b_ptr, b_bf16, vector, consumers if vector else 0,
                grid, out_ptr, *tail, stream)

    return cuda_build.Launch(sys.modules[__name__], ENTRY,
                             "bsr_spmm_error_string", ENTRY, b, m, args,
                             keep, counter, shape)


def block_spmm(indptr: torch.Tensor, indices: torch.Tensor,
               row_order: torch.Tensor, planes: torch.Tensor,
               b: torch.Tensor, m: int, block_size) -> torch.Tensor:
    """Launch K6 on the current stream (:func:`bind`, then the launch),
    for a caller that launches a matrix once."""
    return bind(indptr, indices, row_order, planes, b, m, block_size)(b)
