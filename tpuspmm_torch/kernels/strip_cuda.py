"""Build, load and launch the strip-owner CUDA kernels (csrc/strip_spmm.cu).

The library is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/tpuspmm_torch/`` at the repository root (git-ignored), named by the
hash of the source so an edited source is rebuilt, and bound with ctypes
through a plain C interface.  Nothing here runs when the module is
imported: the CPU tests import it without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "strip_spmm.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "tpuspmm_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
ENTRY_POINTS = ("panel_strip_spmm", "pair_strip_spmm")

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libstrip_spmm-{digest}.so")


def build() -> str:
    """Compile the library unless this source's build exists; return its
    path.  Raises with nvcc's output when the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)  # a concurrent loader never sees a partial file
    return path


def load():
    """The bound library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        args = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_int] + [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.strip_spmm_error_string.argtypes = [ctypes.c_int]
        lib.strip_spmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_TYPES = (torch.float32, torch.bfloat16)


def strip_spmm(entry: str, arrs: dict, b: torch.Tensor, n_out_strips: int,
               tm: int, tk: int) -> torch.Tensor:
    """Launch ``entry`` on the current stream: C (n_out_strips·tm, n) f32
    in the trash-free slab layout from the plan tensors in ``arrs``
    (a_dense, strip_ptr, src_slot, src_kt on b's device).  Checks device,
    dtype, shape and contiguity, and raises on what the kernel does not
    take or on a refused launch."""
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
            out.data_ptr(), n_out_strips, tm, tk, k, n,
            torch.cuda.current_stream(b.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.strip_spmm_error_string(rc).decode()}")
    return out
