"""Global configuration for tpuspmm_torch.

Counterpart of ``tpuspmm/config.py``, cut to what the CSR serving path of
the port reads: the panel-family precision tier, the panel strip count and
the device a host operand is placed on.  The gate's tolerances live in
``utils/compare.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # Panel-family precision tier: "highest" (gate-exact) or "split2"
    # (2-term bf16 splits, verified-only; plain versions only in this port).
    precision_mode: str = "highest"

    # Strips per panel (P) for the panel kernel.  None searches P with the
    # geometry cost model; an int pins it.
    panel_strips: Optional[int] = None

    # Device for a dense operand passed as a host (numpy) array.  None keeps
    # it on the host; a torch tensor always stays on its own device.
    device: Optional[str] = None


_default: Optional[Config] = None


def default_config() -> Config:
    global _default
    if _default is None:
        _default = Config()
    return _default
