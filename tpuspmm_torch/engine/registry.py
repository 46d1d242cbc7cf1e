"""Per-format kernel registries for CSR and COO.

Counterpart of ``tpuspmm/engine/registry.py``, with its numbering (the
reference's): -1 the vendor baseline (torch.sparse, cuSPARSE on the card),
0 the float64 oracle, 1..N the variants, under the JAX package's numbers,
names and ``verified_only`` flags.  A verified-only variant's numerics are
not guaranteed for every operand: only a path that checks its result
against the oracle (the engine runner) serves it; heuristic dispatch
never picks it.

Admission keeps the JAX package's rules where they are about the plan or
the operand (gather bytes, densify size, panel / pair plan bytes, the
compensated path's cost).  The residency rules of the staged and
C-resident variants are the card's (``kernels/csr_vmem.py``,
``kernels/cres_spmm.py``): they admit more than the JAX package's v5e VMEM
budget does, and the runner's records carry the rule.

The BSR and ELL engines are a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from tpuspmm_torch.kernels.common import round_up


@dataclasses.dataclass
class KernelVariant:
    number: int
    name: str
    fn: Callable  # (a, b, config) -> tensor
    description: str = ""
    admissible: Optional[Callable] = None  # (a, b, config) -> bool
    verified_only: bool = False


@dataclasses.dataclass
class Engine:
    fmt: str
    variants: List[KernelVariant]
    supports_vendor: bool = True

    @property
    def num_kernels(self) -> int:
        return len(self.variants)

    def variant(self, number: int) -> KernelVariant:
        for v in self.variants:
            if v.number == number:
                return v
        raise KeyError(number)

    def run_kernel(self, number: int, a, b: torch.Tensor, config=None):
        """-1 vendor, 0 oracle (a float32 tensor on b's device), 1..N the
        variants."""
        from tpuspmm_torch.config import default_config
        from tpuspmm_torch.ops import oracle, vendor

        config = config or default_config()
        if number == -1:
            return vendor.spmm_vendor(a, b)
        if number == 0:
            return torch.from_numpy(oracle.spmm_oracle(
                a, b.float().cpu().numpy())).to(b.device)
        return self.variant(number).fn(a, b, config)


# --------------------------------------------------------------------------
# variants (thin adapters over ops/ and kernels/)
# --------------------------------------------------------------------------

GATHER_MAX_BYTES = 2 << 30  # cap on the gather path's (nnz, n) rows


def _plan(a, config):
    from tpuspmm_torch.formats.tiles import plan_from_container

    return plan_from_container(a, tile_m=config.tile_m, tile_k=config.tile_k,
                               chunk=config.chunk_nnz)


def _xla(a, b, config):
    from tpuspmm_torch.ops import xla

    return xla.spmm_xla(a, b)


def _gather_ok(a, b, config):
    """The gather path's (nnz, n) rows stay within GATHER_MAX_BYTES (the
    JAX package's rule)."""
    return a.nnz * round_up(int(b.shape[1]), 128) * 4 <= GATHER_MAX_BYTES


def _tile(a, b, config):
    from tpuspmm_torch.kernels import tile_spmm

    # JAX's column tile; on the card the kernel's own (64) holds instead
    cap = max(128, config.tile_n_cap // 128 * 128)
    tile_n = min(round_up(int(b.shape[1]), 128), cap)
    return tile_spmm.spmm_tiles(_plan(a, config), b, tile_n=tile_n,
                                mode=config.precision_mode)


def _staged(a, b, config):
    from tpuspmm_torch.kernels import csr_vmem

    return csr_vmem.spmm_staged(_plan(a, config), b,
                                mode=config.precision_mode)


def _staged_ok(a, b, config):
    """The card's staging rule (``csr_vmem.slab_geometry``): at least one
    tile_k-row B stripe stages in a block's opt-in shared memory beside
    its accumulator."""
    from tpuspmm_torch.kernels import csr_vmem

    return csr_vmem.slab_geometry(_plan(a, config), b.device) is not None


def _densify_matmul(a, b, config):
    from tpuspmm_torch.ops import xla

    return xla.spmm_densify_cached(a, b)


def _densify_ok(a, b, config):
    """The JAX package's rule: a dense A within the routing cap always; up
    to 1 GiB only at or above the density floor."""
    from tpuspmm_torch.kernels.dispatch import thresholds

    th = thresholds(b.device)
    dense_bytes = a.shape[0] * a.shape[1] * 4
    if dense_bytes <= th["densify_max_bytes"]:
        return True
    return (dense_bytes <= (1 << 30)
            and a.sparsity >= th["densify_min_density"])


def _cres(a, b, config):
    from tpuspmm_torch.kernels import cres_spmm

    return cres_spmm.spmm_cres(_plan(a, config), b,
                               mode=config.precision_mode)


def _cres_split2(a, b, config):
    from tpuspmm_torch.kernels import cres_spmm

    return cres_spmm.spmm_cres(_plan(a, config), b, mode="split2")


def _cres_ok(a, b, config):
    """The card's C-resident rule (``cres_spmm.fits_card_out``): one
    owner's (tile_m × TN) f32 accumulator fits a block's opt-in shared
    memory."""
    from tpuspmm_torch.kernels import cres_spmm

    return cres_spmm.fits_card_out(config.tile_m, b.device)


def _panel(a, b, config):
    from tpuspmm_torch.kernels import panel_spmm

    return panel_spmm.spmm_panel(a, b, panel_strips=config.panel_strips)


def _panel_split(a, b, config):
    from tpuspmm_torch.kernels import panel_spmm

    return panel_spmm.spmm_panel(a, b, mode="split2",
                                 panel_strips=config.panel_strips)


def _panel_ok(a, b, config):
    """A panel geometry within PLAN_BYTES_CAP exists (the JAX package's
    rule)."""
    from tpuspmm_torch.kernels import panel_spmm

    return panel_spmm.resolve_panel_geometry(
        a, round_up(int(b.shape[1]), 128), panel_strips=config.panel_strips,
        plan_bytes_cap=panel_spmm.PLAN_BYTES_CAP,
        device=b.device) is not None


def _pair(a, b, config):
    from tpuspmm_torch.kernels import pair_spmm

    return pair_spmm.spmm_pair(a, b)


def _pair_split(a, b, config):
    from tpuspmm_torch.kernels import pair_spmm

    return pair_spmm.spmm_pair(a, b, mode="split2")


def _pair_ok(a, b, config):
    """A pair geometry within PLAN_BYTES_CAP exists (the JAX package's
    rule)."""
    from tpuspmm_torch.kernels import pair_spmm

    return pair_spmm.resolve_pair_geometry(
        a, round_up(int(b.shape[1]), 128),
        plan_bytes_cap=pair_spmm.PLAN_BYTES_CAP,
        device=b.device) is not None


def _compensated(a, b, config):
    from tpuspmm_torch.ops import exact

    return exact.spmm_exact(a, b)


def _compensated_ok(a, b, config):
    """The JAX package's affordability caps (``exact.exact_admissible``)."""
    from tpuspmm_torch.ops import exact

    return exact.exact_admissible(a)


def build_engines() -> Dict[str, Engine]:
    V = KernelVariant
    return {
        "csr": Engine("csr", [
            V(1, "xla_segment_sum", _xla,
              "gather of B rows + index_add_ (≙ K1/K3 row-parallel, "
              "spmm_csr_k1.cu:12-34)", admissible=_gather_ok),
            V(2, "pallas_tile_mxu", _tile,
              "nnz-balanced tile chunks, one owner block per output tile "
              "(CUDA, chunk_spmm.cu; ≙ K2 merge-path, spmm_csr_k2.cu:10-58)"),
            V(3, "pallas_staged_b", _staged,
              "B stripe staged in shared memory, whole or k-slabbed (CUDA, "
              "chunk_spmm.cu; ≙ K4 smem staging, spmm_csr_k4.cu:12-79)",
              admissible=_staged_ok),
            V(4, "xla_densify_matmul", _densify_matmul,
              "densify once (cached) + one f32 matmul per call",
              admissible=_densify_ok),
            V(5, "pallas_c_resident", _cres,
              "k-major chunk layout, one owner block per output tile (CUDA, "
              "chunk_spmm.cu)", admissible=_cres_ok),
            V(6, "pallas_c_resident_split2", _cres_split2,
              "C-resident at the 2-term bf16 split tier (~2^-17 error): "
              "served only where the per-matrix gate passes",
              admissible=_cres_ok, verified_only=True),
            V(7, "pallas_panel", _panel,
              "plan-time block densification into strips, strip-owner "
              "kernel (CUDA, strip_spmm.cu; f32, gate-exact)",
              admissible=_panel_ok),
            V(8, "pallas_panel_split", _panel_split,
              "panel kernel at the 2-term bf16 split tier: served only "
              "where the per-matrix gate passes",
              admissible=_panel_ok, verified_only=True),
            V(9, "pallas_pair", _pair,
              "run-length panels, strip-owner kernel (CUDA, strip_spmm.cu; "
              "zero plan padding, gate-exact)", admissible=_pair_ok),
            V(10, "pallas_pair_split", _pair_split,
              "pair kernel at the 2-term bf16 split tier: served only "
              "where the per-matrix gate passes",
              admissible=_pair_ok, verified_only=True),
            V(11, "xla_compensated", _compensated,
              "float64 accumulation, float32 result: deterministic gate "
              "pass for extreme-|value| matrices (≙ the f64 accumulator, "
              "main.cu:185)", admissible=_compensated_ok),
        ]),
        "coo": Engine("coo", [
            V(1, "xla_segment_sum", _xla,
              "gather of B rows + index_add_ (≙ K5 atomicAdd, "
              "spmm_coo_k1.cu:8-27)", admissible=_gather_ok),
            V(2, "pallas_tile_mxu", _tile,
              "tile-plan kernel over the triplets (CUDA, chunk_spmm.cu)"),
            V(3, "pallas_c_resident", _cres,
              "k-major chunk layout, one owner block per output tile (CUDA, "
              "chunk_spmm.cu)", admissible=_cres_ok),
            V(4, "pallas_panel", _panel,
              "plan-time block densification into strips (CUDA, "
              "strip_spmm.cu)", admissible=_panel_ok),
            V(5, "pallas_pair", _pair,
              "run-length panels (CUDA, strip_spmm.cu)",
              admissible=_pair_ok),
            V(6, "xla_compensated", _compensated,
              "float64 accumulation, float32 result (deterministic gate "
              "for extreme values)", admissible=_compensated_ok),
            V(7, "xla_densify_matmul", _densify_matmul,
              "densify once (cached) + one f32 matmul per call",
              admissible=_densify_ok),
        ]),
    }


_ENGINES: Optional[Dict[str, Engine]] = None
FORMATS = ("csr", "coo")


def get_engine(fmt: str) -> Engine:
    """The CSR or COO engine; BSR and ELL raise (a later slice)."""
    global _ENGINES
    fmt = fmt.lower()
    if fmt in ("bsr", "ell"):
        raise NotImplementedError(
            f"the {fmt} engine is not yet ported to tpuspmm_torch: it needs "
            "the BSR / ELL formats and the K6 kernel (ROADMAP Queue 2 K6)")
    if _ENGINES is None:
        _ENGINES = build_engines()
    return _ENGINES[fmt]
