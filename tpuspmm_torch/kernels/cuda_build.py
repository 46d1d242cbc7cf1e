"""Build a CUDA source of tpuspmm_torch/csrc with nvcc and bind it with
ctypes.

A library is compiled at first use for ``sm_90a`` into
``build/tpuspmm_torch/`` at the repository root (git-ignored), named by the
hash of its source so an edited source is rebuilt, and loaded through its
plain C interface.  Nothing here runs when the module is imported: the CPU
tests import it without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Callable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "tpuspmm_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaLibrary:
    """One source under csrc/, built into one shared library.  ``bind``
    sets the argument and result types of its C entry points."""

    def __init__(self, source_name: str, bind: Callable):
        self.source = os.path.join(CSRC, source_name)
        self._bind = bind
        self._lib = None

    def library_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")

    def build(self) -> str:
        """Compile unless this source's build exists; return its path.
        Raises with nvcc's output when the build fails."""
        path = self.library_path()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"({res.returncode}):\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(tmp, path)  # a concurrent loader never sees a partial file
        return path

    def load(self):
        """The bound library, built at first use."""
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            self._bind(lib)
            self._lib = lib
        return self._lib


def check_launch(lib, error_string: str, entry: str, rc: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, error_string)(rc).decode()
        raise RuntimeError(f"{entry} launch failed: {msg}")
