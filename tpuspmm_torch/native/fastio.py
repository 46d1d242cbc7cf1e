"""ctypes binding of ``fastio.cpp``: the token stream of the reference's
text formats and the MatrixMarket coordinate reader (counterpart of
``tpuspmm/native/fastio.py``).

``parse_tokens`` feeds every text reader of ``formats/io.py``;
``read_mtx_triplets`` is ``io.read_mtx``'s path for coordinate files.
Both give numpy's and scipy's values bit for bit.  The C side allocates
the output buffers; each is copied into numpy and then freed.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpuspmm_torch.native.library import NativeLibrary, NativeUnavailable

_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64


def _bind(lib) -> None:
    lib.tokenize_file.restype = ctypes.c_int
    lib.tokenize_file.argtypes = [ctypes.c_char_p, _I64,
                                  ctypes.POINTER(_F64P),
                                  ctypes.POINTER(_I64)]
    lib.read_mtx_coord.restype = ctypes.c_int
    lib.read_mtx_coord.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_I64), ctypes.POINTER(_I64),
        ctypes.POINTER(_I64), ctypes.POINTER(_I32P), ctypes.POINTER(_I32P),
        ctypes.POINTER(_F64P), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.free_buffer.restype = None
    lib.free_buffer.argtypes = [_F64P]
    lib.free_ibuffer.restype = None
    lib.free_ibuffer.argtypes = [_I32P]


LIBRARY = NativeLibrary("fastio.cpp", _bind)


def _take(ptr, n: int, dtype) -> np.ndarray:
    """A numpy copy of ``n`` elements at ``ptr`` (empty for n = 0, where
    the pointer may be null)."""
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).copy()


def parse_tokens(path: str, skip_lines: int = 0) -> np.ndarray:
    """Whitespace-separated float64 values of the file after
    ``skip_lines`` lines."""
    lib = LIBRARY.load()
    out = _F64P()
    n = _I64()
    rc = lib.tokenize_file(path.encode(), skip_lines, ctypes.byref(out),
                           ctypes.byref(n))
    if rc != 0:
        raise NativeUnavailable(f"tokenize_file({path!r}) rc={rc}")
    try:
        return _take(out, n.value, np.float64)
    finally:
        lib.free_buffer(out)


def read_mtx_triplets(path: str):
    """(shape, rows, cols, values) of a MatrixMarket coordinate file:
    0-based int32 indices, float64 values (1.0 for a pattern file), a
    symmetric file's mirrored entries appended after the stored ones.
    Raises ``NativeUnavailable`` for array, complex, skew-symmetric and
    hermitian files, which scipy reads."""
    lib = LIBRARY.load()
    R, C, NZ = _I64(), _I64(), _I64()
    r, c, v = _I32P(), _I32P(), _F64P()
    sym, pat = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.read_mtx_coord(path.encode(), ctypes.byref(R), ctypes.byref(C),
                            ctypes.byref(NZ), ctypes.byref(r),
                            ctypes.byref(c), ctypes.byref(v),
                            ctypes.byref(sym), ctypes.byref(pat))
    if rc != 0:
        raise NativeUnavailable(f"read_mtx_coord({path!r}) rc={rc}")
    try:
        rows, cols, vals = (_take(r, NZ.value, np.int32),
                            _take(c, NZ.value, np.int32),
                            _take(v, NZ.value, np.float64))
    finally:
        lib.free_ibuffer(r)
        lib.free_ibuffer(c)
        lib.free_buffer(v)
    if sym.value == 2:
        raise NativeUnavailable(f"{path!r}: skew-symmetric or hermitian")
    if sym.value == 1:
        off = rows != cols
        rows, cols, vals = (np.concatenate([rows, cols[off]]),
                            np.concatenate([cols, rows[off]]),
                            np.concatenate([vals, vals[off]]))
    return (int(R.value), int(C.value)), rows, cols, vals
