"""A C++ source of tpuspmm_torch/native, built with g++ into a shared
library at most once a process.

``NativeLibrary`` is ``kernels/cuda_build.CudaLibrary`` with g++ and
``HOST_FLAGS``: built at first use into ``build/tpuspmm_torch/``, named by
the hash of its flags and source.  No ``-march=native``: ``build/``
travels with a checkout to other machines (the card's host among them),
and a library tuned to one CPU's instruction set could not load on
another under that name.  A built library that does not load (one copied
from a host with another C++ runtime) is built again once.  A failed
build or load is remembered, so a process with no g++ runs the compiler
once, and every later call raises ``NativeUnavailable`` at once for its
caller to take the numpy path.
"""

from __future__ import annotations

import os
import subprocess

from tpuspmm_torch.kernels.cuda_build import CudaLibrary

_HERE = os.path.dirname(os.path.abspath(__file__))
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


class NativeUnavailable(RuntimeError):
    pass


class NativeLibrary(CudaLibrary):
    flags = HOST_FLAGS

    def __init__(self, source_name: str, bind):
        super().__init__(os.path.join(_HERE, source_name), bind)
        self.error = None

    def compiler(self) -> str:
        return "g++"

    def load(self):
        if self.error is not None:
            raise NativeUnavailable(self.error)
        try:
            try:
                return super().load()
            except OSError:
                if not os.path.exists(self.library_path()):
                    raise
                os.remove(self.library_path())
                return super().load()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            self.error = f"{os.path.basename(self.source)}: " \
                         f"{type(e).__name__}: {e}"
            raise NativeUnavailable(self.error) from e

    def available(self) -> bool:
        try:
            self.load()
            return True
        except NativeUnavailable:
            return False
