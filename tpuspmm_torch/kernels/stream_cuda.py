"""The streaming control's kernel (csrc/stream.cu): y = 2x + 1 over an f32
array in one pass, what ``tools/hbm_control.py`` measures the card's
memory rate with.

Built and bound through :mod:`tpuspmm_torch.kernels.cuda_build`.  Nothing
here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuspmm_torch.kernels import cuda_build

ENTRY = "stream_2x_plus_1"


def _bind(lib) -> None:
    fn = getattr(lib, ENTRY)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.stream_error_string.argtypes = [ctypes.c_int]
    lib.stream_error_string.restype = ctypes.c_char_p


LIBRARY = cuda_build.CudaLibrary("stream.cu", _bind)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (two kernels on a card: 2x, then + 1)."""
    return 2 * x + 1


def stream(x: torch.Tensor) -> torch.Tensor:
    """y = 2x + 1 for a contiguous 1-D float32 ``x``: on a CUDA tensor one
    launch of ``stream_2x_plus_1`` (or it raises), on a CPU tensor
    :func:`stream_plain`."""
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{ENTRY}: x must be a contiguous 1-D float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return stream_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"{ENTRY}: x must be on a CUDA device or the CPU")
    if x.data_ptr() % 16:
        raise ValueError(f"{ENTRY}: x must be 16-byte aligned")
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        rc = getattr(lib, ENTRY)(
            x.data_ptr(), y.data_ptr(), x.numel(), _sm_count(x.device),
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(lib, "stream_error_string", ENTRY, rc)
    stream.launches += 1
    return y


stream.launches = 0
