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

Each kernel's launch is bound once per plan, B width, B dtype and device
(:class:`Launch`): the plan's checks and arguments are taken then, and a
call checks B and launches, as a ``jax.jit``-ed ``pallas_call`` is traced
once per signature and replayed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
from typing import Callable

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "tpuspmm_torch")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (the kernels size their grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
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


_B_TYPES = (torch.float32, torch.bfloat16)


def check_b(entry: str, b) -> None:
    """Refuse a B no kernel takes: not on a CUDA device, or not a
    contiguous 2-D f32 / bf16 tensor."""
    if b.device.type != "cuda":
        raise ValueError(f"{entry}: b must be a CUDA tensor, got {b.device}")
    if b.dim() != 2 or b.dtype not in _B_TYPES or not b.is_contiguous():
        raise ValueError(f"{entry}: b must be a contiguous 2-D f32/bf16 "
                         f"tensor, got {tuple(b.shape)} {b.dtype}")


class Launch:
    """One C entry point's launch, bound to one plan, B width, B dtype and
    device: the plan's checks, its pointers and scalars are taken once,
    when the binding is built (``bind`` in each ``*_cuda`` module, with
    an exemplar B); a call checks only B and launches.

    A call refuses a B that is not CUDA, f32 / bf16, 2-D and contiguous,
    or not of the bound shape, dtype and device; allocates C (rows, n)
    f32 with ``torch.empty``; reads the current stream; makes one ctypes
    call with ``args(b_ptr, out_ptr, stream)``; raises on a refused
    launch; and adds one to ``counter.launches`` (where a counter is
    given).  The library is looked up on ``module`` at each call (its
    ``load``), so a sweep that swaps the library swaps it here too;
    ``keep`` holds every tensor whose pointer the arguments carry;
    ``shape`` is the launch shape the binding decided and passes (a dict,
    or None where the C entry decides it)."""

    __slots__ = ("module", "name", "error_string", "entry", "device",
                 "index", "b_shape", "b_dtype", "out_shape", "args", "keep",
                 "counter", "shape")

    def __init__(self, module, name: str, error_string: str, entry: str, b,
                 rows: int, args: Callable, keep: tuple, counter=None,
                 shape: dict | None = None):
        self.module, self.name = module, name
        self.error_string, self.entry = error_string, entry
        self.device, self.index = b.device, b.device.index
        self.b_shape, self.b_dtype = tuple(b.shape), b.dtype
        self.out_shape = (rows, int(b.shape[1]))
        self.args, self.keep, self.counter = args, keep, counter
        self.shape = shape

    def refuse(self, b) -> None:
        """Raise for a B this launch does not take (the fast check in
        ``__call__`` failed)."""
        check_b(self.entry, b)
        if int(b.shape[0]) != self.b_shape[0]:
            raise ValueError(f"b must be (K={self.b_shape[0]}, N), got "
                             f"{tuple(b.shape)}")
        raise ValueError(
            f"{self.entry}: bound for a {self.b_shape} {self.b_dtype} B on "
            f"{self.device}, got {tuple(b.shape)} {b.dtype} on {b.device}")

    def __call__(self, b):
        if (b.device != self.device or b.dtype != self.b_dtype
                or b.shape != self.b_shape or not b.is_contiguous()):
            self.refuse(b)
        lib = self.module.load()
        # the ctypes launch goes to the current device: make it b's
        if torch.cuda.current_device() == self.index:
            out, rc = self._launch(lib, b)
        else:
            with torch.cuda.device(self.device):
                out, rc = self._launch(lib, b)
        check_launch(lib, self.error_string, self.entry, rc)
        if self.counter is not None:
            self.counter.launches += 1
        return out

    def _launch(self, lib, b) -> tuple:
        out = torch.empty(self.out_shape, dtype=torch.float32,
                          device=self.device)
        stream = torch._C._cuda_getCurrentRawStream(self.index)
        return out, getattr(lib, self.name)(
            *self.args(b.data_ptr(), out.data_ptr(), stream))
