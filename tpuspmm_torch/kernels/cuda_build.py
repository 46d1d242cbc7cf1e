"""Build a CUDA source of tpuspmm_torch/csrc with nvcc and bind it with
ctypes (``native/library.py`` builds the host sources the same way, with
g++).

A library is compiled at first use for ``sm_90a`` into
``build/tpuspmm_torch/`` at the repository root (git-ignored), named by the
hash of its compiler flags, its source and the headers it includes, so an
edited source, header or flag is rebuilt, and loaded through its plain C
interface.  ptxas reports each kernel's registers, shared memory and spills
(``-Xptxas -v``); the compiler's report is kept beside the library
(``CudaLibrary.build_log``).
Nothing here runs when the module is imported: the CPU tests import it
without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from typing import Callable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "tpuspmm_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaLibrary:
    """One source under csrc/, built into one shared library.  ``bind``
    sets the argument and result types of its C entry points."""

    flags = NVCC_FLAGS

    def __init__(self, source_name: str, bind: Callable):
        self.source = os.path.join(CSRC, source_name)
        self._bind = bind
        self._lib = None

    def sources(self) -> list:
        """The source and every header under its directory that it
        includes with quotes, directly or through another header."""
        found, todo = [], [self.source]
        while todo:
            path = todo.pop()
            if path in found:
                continue
            found.append(path)
            with open(path, "rb") as f:
                names = _INCLUDE.findall(f.read())
            for name in names:
                dep = os.path.join(os.path.dirname(path), name.decode())
                if os.path.exists(dep):
                    todo.append(dep)
        return found

    def compiler(self) -> str:
        return nvcc()

    def library_path(self) -> str:
        h = hashlib.sha256(" ".join(self.flags).encode())
        for path in self.sources():
            with open(path, "rb") as f:
                h.update(f.read())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile unless this source's build exists; return its path.
        Raises with the compiler's output when the build fails."""
        path = self.library_path()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        compiler = self.compiler()
        res = subprocess.run([compiler, *self.flags, "-o", tmp, self.source],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{compiler} failed on {self.source} "
                               f"({res.returncode}):\n{res.stdout}\n"
                               f"{res.stderr}")
        with open(f"{tmp}.log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(f"{tmp}.log", self._log_path(path))
        os.replace(tmp, path)  # a concurrent loader never sees a partial file
        return path

    @staticmethod
    def _log_path(library: str) -> str:
        return os.path.splitext(library)[0] + ".log"

    def build_log(self) -> str:
        """The compiler's report (for nvcc, ptxas's registers and spills
        per kernel) of the build of this source, built at first use."""
        with open(self._log_path(self.build())) as f:
            return f.read()

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
