"""Global configuration for tpuspmm_torch.

Counterpart of ``tpuspmm/config.py``: the tile-plan geometry, the
precision tier of the tile-plan kernels, the panel strip count and the
device a host operand is placed on.  The gate's tolerances live in
``utils/compare.py``.  There is no VMEM budget: the residency rules of the
card belong to its kernels (``kernels/csr_vmem.py``, ``kernels/
cres_spmm.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # Tile plan (formats/tiles.py): row-tile and k-tile sizes, and nonzeros
    # per chunk.
    tile_m: int = 128
    tile_k: int = 128
    chunk_nnz: int = 128
    # Cap on the JAX package's output column tile; here it bounds the
    # column block of the tile kernel's plain version (the CUDA kernels'
    # column tile is the card's own, csrc/chunk_spmm.cu).
    tile_n_cap: int = 512

    # Precision tier of the tile-plan kernels (tile, staged, C-resident):
    #  - "split"   3-term bf16 splits (~2^-26), the default;
    #  - "split2"  2-term splits (~2^-17), verified-only;
    #  - "highest" f32 products.
    # The dispatcher serves the panel and pair kernels at "highest"
    # whatever this says, as the JAX package does.
    precision_mode: str = "split"

    # Strips per panel (P) for the panel kernel.  None searches P with the
    # geometry cost model; an int pins it.
    panel_strips: Optional[int] = None

    # Device for a dense operand passed as a host (numpy) array: the card
    # unless the caller asks for the CPU (``Config(device="cpu")``).  A
    # torch tensor always stays on its own device.
    device: str = "cuda"


_default: Optional[Config] = None


def default_config() -> Config:
    global _default
    if _default is None:
        _default = Config()
    return _default
