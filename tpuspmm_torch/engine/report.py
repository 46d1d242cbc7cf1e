"""Record fields and roofline arithmetic.

Counterpart of ``tpuspmm/engine/report.py`` with the reference's own
``cuda*TimeMs`` field names (reference/include/utils.hpp:24-49).
"""

from __future__ import annotations

import json
import sys
from typing import Optional

# Device-memory bandwidth in GB/s, keyed by the name nvidia-smi and
# torch.cuda.get_device_name report (NVIDIA data sheets).
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # H100 SXM
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
}


def hbm_gbps(device_name: str) -> float:
    """Data-sheet memory bandwidth of a card; raises for a name the table
    does not hold."""
    try:
        return HBM_GBPS[device_name]
    except KeyError:
        raise KeyError(f"no memory bandwidth on record for {device_name!r}; "
                       f"known: {sorted(HBM_GBPS)}") from None


def detect_card(device="cpu") -> str:
    """The name times and cached rankings are taken under (counterpart of
    ``detect_chip``): the card's name for a CUDA device, "cpu" otherwise.
    Never initialises CUDA for a CPU device."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def spmm_flops(nnz: int, n: int) -> int:
    """2 flops per nnz per output column (multiply-accumulate)."""
    return 2 * nnz * n


def spmm_min_bytes(nnz: int, m: int, k: int, n: int,
                   index_bytes: int = 4) -> int:
    """Least device-memory traffic: read values and indices once, read B
    once, write C once (f32)."""
    return nnz * (4 + index_bytes) + k * n * 4 + m * n * 4


def make_record(*, testcase: str, sparsity: float, fmt: str, kernel_type,
                kernel_name: str = "", correct: Optional[bool] = None,
                prolog_ms: float = 0.0, kernel_ms: float = 0.0,
                epilog_ms: float = 0.0, sequential_ms: float = 0.0,
                nnz: int = 0, shape=(0, 0), n: int = 0,
                device: str = "", extra: Optional[dict] = None) -> dict:
    """One record in the reference's reportTime schema.  ``device`` names
    what the times were taken on (the card's name, or "cpu"); throughput
    fields are added for a card's kernel time (never a CPU's), and the
    memory-roofline share only on a card the bandwidth table holds."""
    rec = {
        "testcase": testcase,
        "sparsity": sparsity,
        "format": fmt,
        "kernelType": str(kernel_type),
        "kernelName": kernel_name,
        "denseOrdering": "row_major",
        "correct": ("1" if correct else "0") if correct is not None else "",
        "cudaPrologTimeMs": prolog_ms,
        "cudaKernelTimeMs": kernel_ms,
        "cudaEpilogTimeMs": epilog_ms,
        "cudaTotalTimeMs": prolog_ms + kernel_ms + epilog_ms,
        "sequentialTimeMs": sequential_ms,
        "device": device,
        "bCols": int(n),
    }
    if kernel_ms > 0 and nnz and n and device not in ("", "cpu"):
        secs = kernel_ms / 1e3
        rec["gflops"] = spmm_flops(nnz, n) / secs / 1e9
        rec["nnzPerSec"] = nnz / secs
        if device in HBM_GBPS:
            sol = spmm_min_bytes(nnz, shape[0], shape[1], n) / (
                HBM_GBPS[device] * 1e9)
            rec["hbmRooflineFraction"] = sol / secs
    if extra:
        rec.update(extra)
    return rec


def emit(record: dict, stream=None) -> None:
    print(json.dumps(record), file=stream or sys.stdout, flush=True)
