"""Build, load and launch the tile-owner CUDA routine (csrc/chunk_spmm.cu):
the tile-plan kernels K3 (tile) and K4 (staged) through the C entry
``tile_owner_spmm`` (:func:`launch`), K5a and K5b (C-resident) through its
cluster launch ``cres_cluster_spmm`` (:func:`launch_cluster`), all over
one tile index (:func:`tpuspmm_torch.kernels.tile_spmm.build_tile_index`),
the cluster launch also over a cluster schedule
(:func:`tpuspmm_torch.kernels.cres_spmm.cluster_schedule`); an index with
no dense tile, at any tier but "split2", takes the gather build
``gather_spmm`` from any of the four (:func:`bind`).  Each Python entry
passes its own name, for messages.

Built and bound through :mod:`tpuspmm_torch.kernels.cuda_build`.  Nothing
here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import sys

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
# row tiles of a C-resident cluster (the source's CLUSTER, chosen there):
# the cluster launch refuses a schedule of another size
CLUSTER = 2
# the gather build's limits, compiled into the source (GATHER_WARPS,
# GATHER_MAX_ROWS, GATHER_SM_WARPS there; a CPU test holds them equal):
# warps of a block, output rows of a warp, and the warps an SM holds at
# once (the source caps the kernel's registers to fit them)
GATHER_WARPS_MAX = 8
GATHER_MAX_ROWS = 16
GATHER_SM_WARPS = 32
# its launch shape, chosen on the card (PERF.md, strip_sweep.py --chunk):
# output rows of a warp where one row a warp would not fit the card in
# one wave, warps of a block, and passes a warp makes over f32 B wider
# than one pass
GATHER_ROWS = 2
GATHER_WARPS = 8
GATHER_F32_PASSES = 2
# bytes a warp's lanes load from a B row in one pass (32 lanes x 16)
GATHER_PASS_BYTES = 512
# the tile index's device arrays, in the order of the C interface
INDEX = ("row_ptr", "g_col", "g_val", "d_ptr", "d_kt", "d_a", "order")
# the arrays of it the gather build reads
GATHER_INDEX = ("row_ptr", "g_col", "g_val")
# the cluster schedule's device arrays, in the order of the C interface
CLUSTER_INDEX = ("c_rt", "c_ptr", "s_kt", "s_tile", "c_order")


def _bind(lib) -> None:
    lib.tile_owner_spmm.argtypes = (
        [ctypes.c_void_p] * (len(INDEX) + 1) + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.tile_owner_spmm.restype = ctypes.c_int
    lib.cres_cluster_spmm.argtypes = (
        [ctypes.c_void_p] * (len(INDEX) + len(CLUSTER_INDEX) + 1)
        + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p]
        + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.cres_cluster_spmm.restype = ctypes.c_int
    lib.gather_spmm.argtypes = (
        [ctypes.c_void_p] * (len(GATHER_INDEX) + 1)
        + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 8
        + [ctypes.c_void_p])
    lib.gather_spmm.restype = ctypes.c_int
    for name in ("chunk_spmm_blocks_per_sm", "cres_cluster_max_active",
                 "gather_blocks_per_sm"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        getattr(lib, name).restype = ctypes.c_int
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


def column_tile(num_tiles: int, n: int, sms: int) -> int:
    """The routine's column tile for ``num_tiles`` row tiles, B of width n
    and ``sms`` SMs, which :func:`bind` passes to the C entry: 128, or 64
    when 128-column blocks would be fewer than the SMs."""
    wide, narrow = COLUMN_TILES[1], COLUMN_TILES[0]
    return wide if num_tiles * -(-n // wide) >= sms else narrow


def gather_shape(m: int, n: int, b_bf16: bool, sms: int) -> dict:
    """The gather build's launch shape for C (m, n), B of the given dtype
    and ``sms`` SMs, which :func:`bind` passes to ``gather_spmm``.  A lane
    loads 16 bytes of a B row a pass, so a pass covers 128 f32 or 256 bf16
    columns; a warp makes GATHER_F32_PASSES passes over f32 B wider than
    one (their columns in registers, each nonzero read once for all), and
    the grid's second dimension is the column spans of ``passes`` passes.
    A warp owns one row where a warp a row and span fits the card in one
    wave (GATHER_SM_WARPS an SM: a row heavier than the rest then holds up
    no other), else GATHER_ROWS; GATHER_WARPS warps a block."""
    pass_cols = GATHER_PASS_BYTES // (2 if b_bf16 else 4)
    passes = 1 if b_bf16 or n <= pass_cols else GATHER_F32_PASSES
    spans = -(-n // (passes * pass_cols))
    rows = 1 if m * spans <= sms * GATHER_SM_WARPS else GATHER_ROWS
    return {"build": "gather", "rows_per_warp": rows,
            "warps": GATHER_WARPS, "passes": passes,
            "grid": [-(-m // (rows * GATHER_WARPS)), spans]}


def _checked(entry: str, idx: dict, b: torch.Tensor, m: int, tm: int,
             tk: int, split2: bool) -> tuple:
    """Refuse what the routine does not take, before any launch; (row
    tiles, dense tiles) of the index."""
    check_shape(tm)
    cuda_build.check_b(entry, b)
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
    return num_tiles, n_dense


def _checked_cluster(entry: str, sched: dict, b: torch.Tensor,
                     num_tiles: int, issues) -> tuple:
    """Refuse a cluster schedule (and ``issues``) the cluster launch does
    not take; (clusters, cluster)."""
    for name in CLUSTER_INDEX:
        t = sched[name]
        if (t.device != b.device or not t.is_contiguous()
                or t.dtype != torch.int32):
            raise ValueError(f"{entry}: {name} must be a contiguous int32 "
                             f"tensor on {b.device}")
    c_rt, s_tile = sched["c_rt"], sched["s_tile"]
    clusters, cluster = c_rt.shape
    steps = sched["s_kt"].numel()
    if (clusters * cluster < num_tiles or sched["c_ptr"].numel()
            != clusters + 1 or sched["c_order"].numel() != clusters
            or tuple(s_tile.shape) != (steps, cluster)):
        raise ValueError(f"{entry}: the cluster schedule is not over the "
                         f"index's {num_tiles} row tiles")
    if issues is not None and (
            issues.device != b.device or issues.dtype != torch.int32
            or issues.numel() != 1):
        raise ValueError(f"{entry}: issues must be one int32 on {b.device}")
    return clusters, cluster


def bind(entry: str, idx: dict, b: torch.Tensor, m: int, tm: int, tk: int,
         split2: bool, sched: dict | None = None,
         issues: torch.Tensor | None = None,
         counter=None) -> cuda_build.Launch:
    """The launch of the entry named ``entry``, bound to the tile index
    ``idx`` (:data:`INDEX`, on b's device) for B of b's shape, dtype and
    device: C (m, n) f32, at the 2-term tier when ``split2``;
    ``counter.launches`` counts its launches.  Without ``sched`` the owner
    routine (``tile_owner_spmm``); with it the C-resident cluster kernel
    (``cres_cluster_spmm``) over the cluster schedule ``sched``
    (:data:`CLUSTER_INDEX`, on b's device; ``c_rt`` (clusters, R),
    ``s_tile`` (steps, R)), ``issues`` (a one-element int32 tensor on b's
    device, or None when serving) counting its multicast B chunks.
    Checks the index and schedule once, here, and raises on what the
    kernel does not take; the C entry refuses a schedule of another R than
    the build's CLUSTER at the launch.  The build and its shape are
    decided here and kept as the launch's ``shape``: an index with no
    dense tile, but at "split2", takes the gather build
    (:func:`gather_shape`; the cluster has no panel to share, so
    ``issues`` stays untouched); any other the owner routine or the
    cluster launch (``{"build": "owner" | "cluster", "column_tile"}``,
    :func:`column_tile` over the real row tiles, so both take the same
    one)."""
    num_tiles, n_dense = _checked(entry, idx, b, m, tm, tk, split2)
    if sched is not None:
        _checked_cluster(entry, sched, b, num_tiles, issues)
    if n_dense == 0 and not split2:
        return _gather_launch(entry, idx, b, m, counter)
    return _routine_launch(entry, idx, b, m, tm, tk, split2, sched, issues,
                           counter)


def _gather_launch(entry: str, idx: dict, b: torch.Tensor, m: int,
                   counter=None) -> cuda_build.Launch:
    """The gather build's launch (``gather_spmm``) over the index's CSR,
    in the shape :func:`gather_shape` gives."""
    k, n = (int(s) for s in b.shape)
    b_bf16 = b.dtype == torch.bfloat16
    shape = gather_shape(m, n, b_bf16, cuda_build.sm_count(b.device))
    keep = tuple(idx[name] for name in GATHER_INDEX)
    head = tuple(t.data_ptr() for t in keep)
    tail = (m, k, n, shape["rows_per_warp"], shape["warps"],
            shape["passes"], *shape["grid"])

    def args(b_ptr, out_ptr, stream):
        return (*head, b_ptr, int(b_bf16), out_ptr, *tail, stream)

    return cuda_build.Launch(sys.modules[__name__], "gather_spmm",
                             "chunk_spmm_error_string", entry, b, m, args,
                             keep, counter, shape)


def _routine_launch(entry: str, idx: dict, b: torch.Tensor, m: int, tm: int,
                    tk: int, split2: bool, sched: dict | None = None,
                    issues: torch.Tensor | None = None,
                    counter=None) -> cuda_build.Launch:
    """The owner routine's launch (``tile_owner_spmm``), or with ``sched``
    the cluster launch's (``cres_cluster_spmm``), on an index and schedule
    :func:`bind` checked."""
    num_tiles = idx["order"].numel()
    n_dense = idx["d_kt"].numel()
    k, n = (int(s) for s in b.shape)
    keep = tuple(idx[name] for name in INDEX)
    head = tuple(t.data_ptr() for t in keep)
    if sched is not None:
        clusters, cluster = sched["c_rt"].shape
        schedule = tuple(sched[name] for name in CLUSTER_INDEX)
        keep += schedule + ((issues,) if issues is not None else ())
        head += (*(t.data_ptr() for t in schedule),
                 issues.data_ptr() if issues is not None else None, cluster,
                 clusters)
    name = "tile_owner_spmm" if sched is None else "cres_cluster_spmm"
    b_bf16 = int(b.dtype == torch.bfloat16)
    tn = column_tile(num_tiles, n, cuda_build.sm_count(b.device))
    tail = (num_tiles, m, k, n, tm, tk, n_dense, int(split2), tn)

    def args(b_ptr, out_ptr, stream):
        return (*head, b_ptr, b_bf16, out_ptr, *tail, stream)

    return cuda_build.Launch(
        sys.modules[__name__], name, "chunk_spmm_error_string", entry, b, m,
        args, keep, counter,
        {"build": "owner" if sched is None else "cluster",
         "column_tile": tn})


def launch(entry: str, idx: dict, b: torch.Tensor, m: int, tm: int,
           tk: int, split2: bool) -> torch.Tensor:
    """Launch the owner routine on the current stream for the entry named
    ``entry`` (:func:`bind`, then the launch), for a caller that launches
    an index once."""
    return bind(entry, idx, b, m, tm, tk, split2)(b)


def launch_cluster(entry: str, idx: dict, sched: dict, b: torch.Tensor,
                   m: int, tm: int, tk: int, split2: bool,
                   issues: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the C-resident cluster kernel on the current stream for the
    entry named ``entry`` (:func:`bind` with ``sched`` and ``issues``,
    then the launch)."""
    return bind(entry, idx, b, m, tm, tk, split2, sched, issues)(b)


def blocks_per_sm(b_bf16: bool, wide: bool, split2: bool) -> int:
    """Blocks of one instantiation of the owner routine an SM holds at once
    (the occupancy calculator on the current device), for a record."""
    return _occupancy("chunk_spmm_blocks_per_sm", b_bf16, wide, split2)


def max_active_clusters(b_bf16: bool, wide: bool, split2: bool) -> int:
    """Clusters of one instantiation of the cluster launch the current
    device holds at once (``cudaOccupancyMaxActiveClusters``)."""
    return _occupancy("cres_cluster_max_active", b_bf16, wide, split2)


def gather_blocks(b_bf16: bool, passes: int, warps: int) -> int:
    """Blocks of ``warps`` warps of the gather build an SM holds at once
    (the occupancy calculator on the current device), for a record."""
    return _occupancy("gather_blocks_per_sm", b_bf16, passes, warps)


def _occupancy(name: str, *args) -> int:
    lib = load()
    err = ctypes.c_int(0)
    count = getattr(lib, name)(*(int(a) for a in args), ctypes.byref(err))
    cuda_build.check_launch(lib, "chunk_spmm_error_string", name, err.value)
    return count
