"""What the sweeps share: the device they run on and the tally of their
records into an exit status."""

from __future__ import annotations

import sys


def resolve_device(name: str):
    """The torch device ``name`` names, or None (with the reason on stderr)
    when it is not a CUDA device present here or the CPU."""
    import torch

    try:
        device = torch.device(name)
    except RuntimeError as e:
        print(f"bad --device {name!r}: {e}", file=sys.stderr)
        return None
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"no CUDA device for --device {name}", file=sys.stderr)
        return None
    if device.type not in ("cuda", "cpu"):
        print(f"--device must be a CUDA device or cpu, got {name}",
              file=sys.stderr)
        return None
    return device


class Tally:
    """Counts of a sweep's records: ``failures`` (an incorrect record that
    is not verified-only, or an error record), ``verified_only_misses``
    and ``faulted_groups`` (a group with a ``device_fault`` record)."""

    def __init__(self):
        self.failures = 0
        self.verified_only_misses = 0
        self.faulted_groups = 0

    def add(self, rec: dict) -> None:
        if rec.get("correct") == "0":
            if rec.get("verifiedOnly") == "1":
                self.verified_only_misses += 1
            else:
                self.failures += 1
        elif "error" in rec:
            self.failures += 1

    def status(self) -> int:
        """2 on a faulted group, 1 on a failure, else 0 (the JAX sweeps'
        codes: a fault outranks a failure, so an isolating parent re-runs
        the group)."""
        return 2 if self.faulted_groups else (1 if self.failures else 0)


def group_faulted(records) -> bool:
    """A CUDA error poisoned the context in this group: its later
    variants and the vendor baseline did not run."""
    return any(r.get("device_fault") == "1" for r in records)


def hand_kernels() -> dict:
    """name: the entry point whose ``launches`` counts its hand kernel's
    launches on the card (K1 panel ... K6 bsr_stream)."""
    from tpuspmm_torch.kernels import (bsr_spmm, cres_spmm, csr_vmem,
                                       pair_spmm, panel_spmm, tile_spmm)

    return {"panel": panel_spmm.spmm_panel, "pair": pair_spmm.spmm_pair,
            "tile": tile_spmm.spmm_tiles, "staged": csr_vmem.spmm_staged,
            "cres": cres_spmm.spmm_cres,
            "cres_kloop": cres_spmm.spmm_cres_kloop,
            "bsr_stream": bsr_spmm.spmm_bsr_stream}
