"""ctypes binding of ``tileplan.cpp``, the tile-plan builder (counterpart
of ``tpuspmm/native/tileplan.py``).

``build_tile_plan_arrays`` returns the arrays ``formats/tiles.py``'s numpy
path builds, bit for bit.  The C side sorts and groups, the caller
allocates the outputs in numpy at the chunk count it returns (prefilled
with the sentinels), and the fill frees the C state; a state that is not
filled is discarded.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpuspmm_torch.native.library import NativeLibrary

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64


def _bind(lib) -> None:
    lib.tile_plan_begin.restype = ctypes.c_void_p
    lib.tile_plan_begin.argtypes = [_I64P, _I64P, _F32P, _I64, _I64, _I64,
                                    _I64, _I64, _I64, _I64P]
    lib.tile_plan_fill.restype = None
    lib.tile_plan_fill.argtypes = [ctypes.c_void_p, _I64, _I32P, _I32P,
                                   _I32P, _I32P, _I32P, _F32P]
    lib.tile_plan_discard.restype = None
    lib.tile_plan_discard.argtypes = [ctypes.c_void_p]


LIBRARY = NativeLibrary("tileplan.cpp", _bind)


def build_tile_plan_arrays(rows, cols, vals, shape, tile_m: int, tile_k: int,
                           chunk: int):
    """(rt, kt, first, rows, cols, vals) of the tile plan.  Raises
    ``NativeUnavailable`` when the library does not build or load, and
    ValueError for an index outside ``shape``."""
    lib = LIBRARY.load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    m, k = int(shape[0]), int(shape[1])
    nnz = rows.shape[0]
    if cols.shape[0] != nnz or vals.shape[0] != nnz:
        raise ValueError("rows, cols and vals differ in length")
    if nnz and (rows.min() < 0 or rows.max() >= m or cols.min() < 0
                or cols.max() >= k):
        raise ValueError(f"an index lies outside the shape {shape}")
    n_chunks = _I64()
    state = lib.tile_plan_begin(
        rows.ctypes.data_as(_I64P), cols.ctypes.data_as(_I64P),
        vals.ctypes.data_as(_F32P), nnz, m, k, int(tile_m), int(tile_k),
        int(chunk), ctypes.byref(n_chunks))
    if not state:
        raise MemoryError("tile_plan_begin: out of host memory")
    try:
        C, E = n_chunks.value, int(chunk)
        out = (np.zeros(C, np.int32), np.zeros(C, np.int32),
               np.zeros(C, np.int32), np.full((C, E), -1, np.int32),
               np.zeros((C, E), np.int32), np.zeros((C, E), np.float32))
    except BaseException:
        lib.tile_plan_discard(state)
        raise
    rt, kt, first, prows, pcols, pvals = out
    lib.tile_plan_fill(state, C, rt.ctypes.data_as(_I32P),
                       kt.ctypes.data_as(_I32P), first.ctypes.data_as(_I32P),
                       prows.ctypes.data_as(_I32P),
                       pcols.ctypes.data_as(_I32P),
                       pvals.ctypes.data_as(_F32P))
    return out
