"""Build, load and launch the strip-owner CUDA kernels (csrc/strip_spmm.cu).

Built and bound through :mod:`tpuspmm_torch.kernels.cuda_build` (nvcc for
``sm_90a`` at first use into ``build/tpuspmm_torch/``, ctypes).  Nothing
here runs when the module is imported: the CPU tests import it without a
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from tpuspmm_torch.kernels import cuda_build

BUILD_DIR = cuda_build.BUILD_DIR
NVCC_FLAGS = cuda_build.NVCC_FLAGS
ENTRY_POINTS = ("panel_strip_spmm", "pair_strip_spmm")
# output rows one block owns: GROUP_ROWS // tm consecutive output strips
# share each B tile.  The kernel is compiled for it (GROUP_ROWS in
# csrc/strip_spmm.cu) and the wrapper checks the group index against it
GROUP_ROWS = 64


def _bind(lib) -> None:
    args = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.strip_spmm_error_string.argtypes = [ctypes.c_int]
    lib.strip_spmm_error_string.restype = ctypes.c_char_p


LIBRARY = cuda_build.CudaLibrary("strip_spmm.cu", _bind)
SOURCE = LIBRARY.source
library_path = LIBRARY.library_path
build = LIBRARY.build
load = LIBRARY.load


_TYPES = (torch.float32, torch.bfloat16)
_INDEX = ("group_ptr", "group_kt", "group_slot", "group_order")


def _checked(entry: str, arrs: dict, b: torch.Tensor, n_out_strips: int,
             tm: int, tk: int) -> int:
    """Refuse what the kernel does not take, before any launch: B (as
    ``cuda_build.check_b``) and the plan tensors' device, dtype, shape,
    contiguity and alignment; the group count."""
    cuda_build.check_b(entry, b)
    a = arrs["a_dense"]
    idx = [arrs[k] for k in _INDEX]
    if a.dtype not in _TYPES or a.dim() != 2 or a.shape[1] != tk:
        raise ValueError(f"{entry}: a_dense must be (rows, {tk}) f32/bf16")
    for t in (a, *idx):
        if t.device != b.device or not t.is_contiguous():
            raise ValueError(f"{entry}: plan tensors must be contiguous on "
                             f"{b.device}")
    if any(t.dtype != torch.int32 for t in idx):
        raise ValueError(f"{entry}: group index must be int32")
    if tm not in (8, 16, 32) or tk % 128:
        raise ValueError(f"{entry}: tm must be 8, 16 or 32 and tk a "
                         f"multiple of 128, got tm={tm} tk={tk}")
    G = GROUP_ROWS // tm
    n_groups = -(-n_out_strips // G)
    if (idx[0].numel() != n_groups + 1 or idx[3].numel() != n_groups
            or idx[2].shape[-1:] != (G,)):
        raise ValueError(f"{entry}: the group index is not over {G} of "
                         f"{n_out_strips} output strips")
    if a.data_ptr() % 16:
        raise ValueError(f"{entry}: a_dense must be 16-byte aligned")
    return n_groups


def bind(entry: str, arrs: dict, b: torch.Tensor, n_out_strips: int,
         tm: int, tk: int, split2: bool = False,
         counter=None) -> cuda_build.Launch:
    """``entry``'s launch bound to the plan tensors in ``arrs`` (a_dense,
    and group_ptr, group_kt, group_slot of the plan's group index over
    ``GROUP_ROWS // tm`` output strips with group_order, the groups by
    entries, most first, on b's device) for B of b's shape, dtype and
    device: C (n_out_strips·tm, n) f32 in the trash-free slab layout, at
    the 2-term tier when ``split2``; ``counter.launches`` counts its
    launches.  Checks the plan once, here, and raises on what the kernel
    does not take."""
    n_groups = _checked(entry, arrs, b, n_out_strips, tm, tk)
    a = arrs["a_dense"]
    idx = tuple(arrs[k] for k in _INDEX)
    k, n = (int(s) for s in b.shape)
    head = (a.data_ptr(), int(a.dtype == torch.bfloat16))
    mid = (int(b.dtype == torch.bfloat16), *(t.data_ptr() for t in idx))
    tail = (n_groups, n_out_strips * tm, tm, tk, k, n,
            cuda_build.sm_count(b.device), int(split2))

    def args(b_ptr, out_ptr, stream):
        return (*head, b_ptr, *mid, out_ptr, *tail, stream)

    return cuda_build.Launch(sys.modules[__name__], entry,
                             "strip_spmm_error_string", entry, b,
                             n_out_strips * tm, args, (a, *idx), counter)


def strip_spmm(entry: str, arrs: dict, b: torch.Tensor, n_out_strips: int,
               tm: int, tk: int, split2: bool = False) -> torch.Tensor:
    """Launch ``entry`` on the current stream: :func:`bind`, then the
    launch, for a caller that launches a plan once."""
    return bind(entry, arrs, b, n_out_strips, tm, tk, split2)(b)
