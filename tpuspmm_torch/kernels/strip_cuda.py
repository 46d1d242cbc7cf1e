"""Build, load and launch the strip-owner CUDA kernels (csrc/strip_spmm.cu).

Built and bound through :mod:`tpuspmm_torch.kernels.cuda_build` (nvcc for
``sm_90a`` at first use into ``build/tpuspmm_torch/``, ctypes).  Nothing
here runs when the module is imported: the CPU tests import it without a
CUDA toolkit.
"""

from __future__ import annotations

import ctypes

import torch

from tpuspmm_torch.kernels import cuda_build

BUILD_DIR = cuda_build.BUILD_DIR
NVCC_FLAGS = cuda_build.NVCC_FLAGS
ENTRY_POINTS = ("panel_strip_spmm", "pair_strip_spmm")


def _bind(lib) -> None:
    args = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
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


def strip_spmm(entry: str, arrs: dict, b: torch.Tensor, n_out_strips: int,
               tm: int, tk: int, split2: bool = False) -> torch.Tensor:
    """Launch ``entry`` on the current stream: C (n_out_strips·tm, n) f32
    in the trash-free slab layout from the plan tensors in ``arrs``
    (a_dense, strip_ptr, src_slot, src_kt on b's device), at the 2-term
    tier when ``split2``.  Checks device, dtype, shape and contiguity, and
    raises on what the kernel does not take or on a refused launch."""
    a = arrs["a_dense"]
    idx = [arrs[k] for k in ("strip_ptr", "src_slot", "src_kt")]
    if b.device.type != "cuda":
        raise ValueError(f"{entry}: b must be a CUDA tensor, got {b.device}")
    if b.dim() != 2 or b.dtype not in _TYPES or not b.is_contiguous():
        raise ValueError(f"{entry}: b must be a contiguous 2-D f32/bf16 "
                         f"tensor, got {tuple(b.shape)} {b.dtype}")
    if a.dtype not in _TYPES or a.dim() != 2 or a.shape[1] != tk:
        raise ValueError(f"{entry}: a_dense must be (rows, {tk}) f32/bf16")
    for t in (a, *idx):
        if t.device != b.device or not t.is_contiguous():
            raise ValueError(f"{entry}: plan tensors must be contiguous on "
                             f"{b.device}")
    if any(t.dtype != torch.int32 for t in idx):
        raise ValueError(f"{entry}: strip index must be int32")
    if tm not in (8, 16, 32) or tk % 128:
        raise ValueError(f"{entry}: tm must be 8, 16 or 32 and tk a "
                         f"multiple of 128, got tm={tm} tk={tk}")
    if idx[0].numel() != n_out_strips + 1:
        raise ValueError(f"{entry}: strip_ptr has {idx[0].numel()} entries "
                         f"for {n_out_strips} output strips")
    k, n = b.shape
    lib = load()
    # the ctypes launch goes to the current device: make it b's
    with torch.cuda.device(b.device):
        out = torch.empty((n_out_strips * tm, n), dtype=torch.float32,
                          device=b.device)
        rc = getattr(lib, entry)(
            a.data_ptr(), int(a.dtype == torch.bfloat16), b.data_ptr(),
            int(b.dtype == torch.bfloat16), *(t.data_ptr() for t in idx),
            out.data_ptr(), n_out_strips, tm, tk, k, n, int(split2),
            torch.cuda.current_stream(b.device).cuda_stream)
    cuda_build.check_launch(lib, "strip_spmm_error_string", entry, rc)
    return out
