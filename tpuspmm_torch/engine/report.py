"""Record fields and roofline arithmetic.

Counterpart of ``tpuspmm/engine/report.py`` with the reference's own
``cuda*TimeMs`` field names (reference/include/utils.hpp:24-49).
"""

from __future__ import annotations

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
                kernel_ms: float = 0.0, n: int = 0,
                extra: Optional[dict] = None) -> dict:
    """One record in the reference's reportTime schema; this port times
    the serve as one kernel span, so prolog and epilog read 0."""
    rec = {
        "testcase": testcase,
        "sparsity": sparsity,
        "format": fmt,
        "kernelType": str(kernel_type),
        "kernelName": kernel_name,
        "denseOrdering": "row_major",
        "correct": ("1" if correct else "0") if correct is not None else "",
        "cudaPrologTimeMs": 0.0,
        "cudaKernelTimeMs": kernel_ms,
        "cudaEpilogTimeMs": 0.0,
        "cudaTotalTimeMs": kernel_ms,
        "sequentialTimeMs": 0.0,
        "bCols": int(n),
    }
    if extra:
        rec.update(extra)
    return rec
