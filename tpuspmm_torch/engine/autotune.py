"""Autotuner: measure every admissible variant once, serve the winner.

Counterpart of ``tpuspmm/engine/autotune.py``.  The dispatcher's cost
model is unfitted on the card (``kernels/dispatch.py``), so for a matrix
that is served many times it pays to measure once per (matrix, width, B
dtype): ``tune`` times every admissible variant of the format's engine and
the vendor baseline (torch.sparse CSR @ dense, cuSPARSE on the card,
kernel -1) with ``utils.timing.serve_time_ms``, keeps only those whose
result passes the gate against the scipy f64 oracle, and ranks them.  For
the panel and pair kernels it measures the model's top
``GEOM_CANDIDATES_K`` geometries and pins the fastest, so serving
dispatches the geometry that was measured.  The ranking is cached on the
container and in a JSON file keyed by the matrix digest, width, card,
engine revision, Config fingerprint, cost constants and B dtype
(``utils/disk_cache.py``: ``TPUSPMM_TORCH_TUNE_CACHE``, else
~/.cache/tpuspmm_torch/tune.json for a CUDA device, none for a CPU one).
``spmm(a, b, method="tuned")`` serves the first entry that is not
verified-only, tuning on first use.

Unlike the JAX package: a variant that raises stops the tune (on the card
an exception is a fault to see, not a transient one to retry on resume);
each variant's time is the least of ``TIMING_WINDOWS`` medians; the
variant that the dispatcher serves by default leads the ranking when it
is within ``DEFAULT_TIE`` of the fastest entry that is not verified-only
(a host-bound serve's spread, so noise does not move a serve off the
default route); and a pinned geometry is keyed by the B dtype too.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import sys
import time
from typing import List, Optional, Set, Tuple

import torch

from tpuspmm_torch.formats.base import container_cache
from tpuspmm_torch.utils import disk_cache, timing
from tpuspmm_torch.utils.compare import allclose
from tpuspmm_torch.utils.disk_cache import matrix_digest


@dataclasses.dataclass
class TuneResult:
    variant_name: str
    number: int
    ms: float
    # a split tier whose gate pass depends on the operand's values: served
    # only to callers that check each result, never by ``spmm_tuned``
    verified_only: bool = False
    # the measured panel / pair geometry: (tm, P, tk, sm, order, plan_mb)
    # or (CH, sm, order, plan_mb)
    geom: Optional[dict] = None


# each variant is timed in this many windows and its least median kept
TIMING_WINDOWS = 3
# the default route leads the ranking within this share of the fastest
DEFAULT_TIE = 0.10
# the registry variant that serves each of ``dispatch.route``'s paths
_ROUTE_VARIANT = {
    "exact": "xla_compensated", "bsr_stream": "pallas_block_stream",
    "densify": "xla_densify_matmul", "panel": "pallas_panel",
    "pair": "pallas_pair", "staged": "pallas_staged_b",
    "cres": "pallas_c_resident", "tile": "pallas_tile_mxu",
    "xla": "xla_segment_sum",
}


def _config_fp(config=None) -> str:
    """Fingerprint of the Config fields that change a variant's numerics or
    geometry: a ranking verified under one must not be served under
    another.  ``device`` is not one (the card is in the disk key)."""
    if config is None:
        from tpuspmm_torch.config import default_config

        config = default_config()
    return _fingerprint((config.precision_mode, config.tile_m,
                         config.tile_k, config.chunk_nnz, config.tile_n_cap,
                         config.panel_strips))


@functools.lru_cache(maxsize=64)
def _fingerprint(fields: tuple) -> str:
    """Hashed once per field tuple: a tuned serve looks its ranking up by
    it on every call."""
    return hashlib.sha1(repr(fields).encode()).hexdigest()[:8]


def _serving_operand(b, config) -> torch.Tensor:
    """B as it is tuned and served: a bf16 tensor stays bf16, anything
    else becomes float32, on its device (a host array on
    ``config.device``)."""
    from tpuspmm_torch.ops.api import _as_tensor

    b = _as_tensor(b, config)
    if b.dtype != torch.bfloat16:
        b = b.float()
    return b.contiguous()


def _b_dtype_name(b: torch.Tensor) -> str:
    return str(b.dtype).removeprefix("torch.")


def _tune_key(b: torch.Tensor, config=None) -> tuple:
    """Container-cache key of a ranking: width, Config fingerprint and the
    serving dtype (a bf16 ranking has other winners and another gate)."""
    return ("tuned", int(b.shape[1]), _config_fp(config), _b_dtype_name(b))


def _as_tunable(a):
    """A container outside the engines (CSC) tunes through its CSR view,
    cached on it so its ranking caches too."""
    from tpuspmm_torch.engine.registry import FORMATS

    if a.format_name in FORMATS:
        return a
    cache = container_cache(a)
    if "tunable_csr" not in cache:
        cache["tunable_csr"] = a.to_csr()
    return cache["tunable_csr"]


def _engine_rev(fmt: str) -> str:
    """Fingerprint of the format's candidates, so a ranking measured
    before a variant was added is not served."""
    from tpuspmm_torch.engine.registry import get_engine

    eng = get_engine(fmt)
    names = ",".join(v.name for v in eng.variants)
    if eng.supports_vendor:
        names += ",vendor"
    return hashlib.sha1(names.encode()).hexdigest()[:8]


def _vendor_variant():
    """The vendor baseline as a candidate, kernel -1: served whenever it
    beats every hand kernel."""
    from tpuspmm_torch.engine.registry import KernelVariant
    from tpuspmm_torch.ops import vendor

    return KernelVariant(-1, "torch_sparse_csr",
                         lambda a, b, config: vendor.spmm_vendor(a, b),
                         "torch.sparse CSR @ dense (cuSPARSE on the card)")


def _disk_path(device) -> Optional[str]:
    return disk_cache.cache_path("TPUSPMM_TORCH_TUNE_CACHE", "tune.json",
                                 device)


def _disk_key(a, b: torch.Tensor, config=None) -> str:
    """The ranking's key in the tune file: matrix digest, format, width,
    the card's name (the "cpu" cost constants are the H100's, so they
    cannot tell a CPU ranking from a card's), engine revision, Config
    fingerprint, the device's cost constants (a refit also turns over the
    pinned geometries) and the B dtype."""
    from tpuspmm_torch.engine import report
    from tpuspmm_torch.kernels.dispatch import thresholds

    th_fp = hashlib.sha1(repr(sorted(thresholds(b.device).items())).encode()
                         ).hexdigest()[:8]
    return (f"v1:{matrix_digest(a)}:{a.format_name}:n{int(b.shape[1])}"
            f":{report.detect_card(b.device)}:e{_engine_rev(a.format_name)}"
            f":c{_config_fp(config)}:t{th_fp}:d{_b_dtype_name(b)}")


def _disk_load(path: str, key: str
               ) -> Optional[Tuple[List[TuneResult], Set[str], bool]]:
    """(results, variants attempted, complete?) of a stored entry: a
    partial one (a run cut by its budget) resumes."""
    entry = disk_cache.read(path).get(key)
    if entry is None:
        return None
    return ([TuneResult(**r) for r in entry["results"]],
            set(entry["done"]), bool(entry["complete"]))


def _disk_store(path: str, key: str, results: List[TuneResult],
                done: Set[str], complete: bool) -> None:
    disk_cache.write(path, key, {
        "results": [dataclasses.asdict(r) for r in results],
        "done": sorted(done), "complete": complete})


# ---------------------------------------------------------------------------
# geometry candidates of the panel and pair kernels
# ---------------------------------------------------------------------------

_GEOM_FAMILIES = {
    "pallas_panel": "panel", "pallas_panel_split": "panel",
    "pallas_pair": "pair", "pallas_pair_split": "pair",
}
GEOM_CANDIDATES_K = 3


def _geom_candidates(family: str, a, b: torch.Tensor, config,
                     k: int = GEOM_CANDIDATES_K):
    from tpuspmm_torch.kernels import pair_spmm, panel_spmm
    from tpuspmm_torch.kernels.common import round_up

    n_pad = round_up(int(b.shape[1]), 128)
    if family == "panel":
        return panel_spmm.resolve_panel_geometry_candidates(
            a, n_pad, k=k, panel_strips=config.panel_strips,
            plan_bytes_cap=panel_spmm.PLAN_BYTES_CAP, device=b.device)
    return pair_spmm.resolve_pair_geometry_candidates(
        a, n_pad, k=k, plan_bytes_cap=pair_spmm.PLAN_BYTES_CAP,
        device=b.device)


def _pin_geom(family: str, a, geom, b: torch.Tensor, config,
              disk: bool = True) -> None:
    """Pin ``geom`` under the resolver key the serving call builds
    (``spmm_panel`` / ``spmm_pair`` and ``_panel_ok`` / ``_pair_ok``:
    n_pad = round_up(N, 128), Config's panel_strips, PLAN_BYTES_CAP, b's
    device and dtype).  ``disk=False`` pins the container only, so a
    candidate measured by a process that is killed never persists."""
    from tpuspmm_torch.kernels import pair_spmm, panel_spmm
    from tpuspmm_torch.kernels.common import round_up

    n_pad = round_up(int(b.shape[1]), 128)
    if family == "panel":
        panel_spmm.pin_panel_geometry(
            a, geom, n_pad=n_pad, panel_strips=config.panel_strips,
            plan_bytes_cap=panel_spmm.PLAN_BYTES_CAP, device=b.device,
            b_dtype=b.dtype, disk=disk)
    else:
        pair_spmm.pin_pair_geometry(
            a, geom, n_pad=n_pad, plan_bytes_cap=pair_spmm.PLAN_BYTES_CAP,
            device=b.device, b_dtype=b.dtype, disk=disk)


def _geom_record(family: str, geom) -> dict:
    """The geometry's provenance, carried by the ranking and the bench."""
    if family == "panel":
        return {"family": "panel", "tm": int(geom.tm),
                "P": int(geom.panel_strips), "tk": int(geom.tk),
                "sm": int(geom.sm), "order": geom.order_kind,
                "plan_mb": round(geom.plan_bytes / 1e6, 2)}
    return {"family": "pair", "CH": int(geom.chunk_strips),
            "sm": int(geom.sm), "order": geom.order_kind,
            "plan_mb": round(geom.plan_bytes / 1e6, 2)}


def _log(verbose: bool, msg: str) -> None:
    if verbose:
        print(f"# tune: {msg}", file=sys.stderr, flush=True)


def _time(fn, b: torch.Tensor, iters: int) -> float:
    return timing.serve_time_ms(fn, b, iters, windows=TIMING_WINDOWS)


def _measure_family(family, variant, a, b, config, ref, iters, verbose):
    """Pin and measure each of the model's top geometries of a panel or
    pair variant and pin the fastest, on the container and on disk.
    Returns (its ms, its geometry record), or (None, None) when every
    candidate fails the gate; a failing sweep leaves candidate 0 (the
    resolver's own pick) pinned on the container."""
    cands = _geom_candidates(family, a, b, config)
    fn = lambda bb: variant.fn(a, bb, config)  # noqa: E731
    if not cands:  # admitted, yet no candidate: serve what resolves
        if not allclose(fn(b), ref):
            return None, None
        return _time(fn, b, iters), None
    best = None  # (ms, geometry)
    try:
        for g in cands:
            _pin_geom(family, a, g, b, config, disk=False)
            if not allclose(fn(b), ref):
                continue
            ms = _time(fn, b, iters)
            _log(verbose, f"{variant.name} candidate "
                          f"{_geom_record(family, g)}: {ms:.4f} ms")
            if best is None or ms < best[0]:
                best = (ms, g)
    finally:
        if best is None:
            _pin_geom(family, a, cands[0], b, config, disk=False)
    if best is None:
        return None, None
    _pin_geom(family, a, best[1], b, config)
    return best[0], _geom_record(family, best[1])


def _reanchor(results, engine, a, b, config, iters, verbose):
    """Scale a resumed ranking's times by this run's speed of its first
    stored variant (times from another process are not comparable); []
    when none of them can be run again."""
    by_name = {v.name: v for v in engine.variants}
    anchor = next((r for r in results if r.variant_name in by_name
                   and not r.verified_only), None)
    if anchor is None:
        return []
    v = by_name[anchor.variant_name]
    now = _time(lambda bb: v.fn(a, bb, config), b, iters)
    scale = now / anchor.ms if anchor.ms > 0 else 1.0
    if abs(scale - 1.0) <= 0.05:
        return results
    _log(verbose, f"re-anchored the resumed ranking on {v.name} "
                  f"(speed ratio {scale:.3f})")
    return [dataclasses.replace(r, ms=round(r.ms * scale, 4))
            for r in results]


def _default_first(results: List[TuneResult], a, b: torch.Tensor,
                   config) -> List[TuneResult]:
    """``results`` fastest first, except that the variant the dispatcher
    serves by default leads when its time is within ``DEFAULT_TIE`` of the
    fastest entry that is not verified-only."""
    from tpuspmm_torch.kernels import dispatch

    results = sorted(results, key=lambda r: r.ms)
    lead = next((r for r in results if not r.verified_only), None)
    name = _ROUTE_VARIANT.get(dispatch.route(a, b, config))
    default = next((r for r in results if r.variant_name == name), None)
    if (lead is None or default is None or default is results[0]
            or default.ms > lead.ms * (1 + DEFAULT_TIE)):
        return results
    return [default] + [r for r in results if r is not default]


def tune(a, b, iters: int = 8, config=None, verbose: bool = False,
         budget_s: Optional[float] = None) -> List[TuneResult]:
    """Measure every admissible variant of ``a``'s engine and the vendor
    on B's device and dtype; cache and return the ranking, fastest first
    (the default route first within ``DEFAULT_TIE``).

    A variant is ranked only when its result passes the gate against the
    scipy f64 oracle (of the bf16 values when B is bf16).  Each measured
    variant is stored in the tune file at once, so a run that is cut
    resumes where it stopped; with ``budget_s`` the run stops between
    variants once the budget is spent and stores a partial entry, which is
    not served until a later call completes it."""
    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.engine.registry import get_engine
    from tpuspmm_torch.ops import oracle

    config = config or default_config()
    a = _as_tunable(a)
    b = _serving_operand(b, config)
    engine = get_engine(a.format_name)

    path = _disk_path(b.device)
    dkey = _disk_key(a, b, config) if path is not None else None
    results: List[TuneResult] = []
    done: Set[str] = set()
    stored = _disk_load(path, dkey) if dkey is not None else None
    if stored is not None:
        results, done, complete = stored
        if complete and results:
            _attach(a, b, results, config)
            return results
        if results:
            _log(verbose, f"resuming: {len(done)} variants attempted, "
                          f"{len(results)} ranked")
            results = _reanchor(results, engine, a, b, config, iters,
                                verbose)
            if not results:
                done = set()

    ref = oracle.spmm_scipy_oracle(a, b.float().cpu().numpy())
    t_start = time.monotonic()
    out_of_budget = False
    attempted = 0  # at least one a call, so a tight budget progresses
    candidates = list(engine.variants)
    if engine.supports_vendor:
        candidates.append(_vendor_variant())
    # one geometry sweep per family: the split tier serves the geometry
    # its sibling's sweep pinned
    family_geom = {}
    for r in results:
        fam = _GEOM_FAMILIES.get(r.variant_name)
        if fam is not None and r.geom is not None:
            family_geom.setdefault(fam, r.geom)
    for variant in candidates:
        if variant.name in done:
            continue
        if (budget_s is not None and attempted > 0
                and time.monotonic() - t_start > budget_s):
            out_of_budget = True
            _log(verbose, f"budget {budget_s:g} s spent; the rest is left "
                          "for a resume")
            break
        if (variant.admissible is not None
                and not variant.admissible(a, b, config)):
            done.add(variant.name)
            continue
        attempted += 1
        family = _GEOM_FAMILIES.get(variant.name)
        geom = family_geom.get(family) if family else None
        if family is not None and family not in family_geom:
            ms, geom = _measure_family(family, variant, a, b, config, ref,
                                       iters, verbose)
            if geom is not None:
                family_geom[family] = geom
        else:
            fn = lambda bb, v=variant: v.fn(a, bb, config)  # noqa: E731
            ms = _time(fn, b, iters) if allclose(fn(b), ref) else None
        done.add(variant.name)
        if ms is None:
            _log(verbose, f"{variant.name} failed the gate; excluded")
        else:
            results.append(TuneResult(variant.name, variant.number,
                                      round(ms, 4),
                                      bool(variant.verified_only), geom))
            _log(verbose, f"{variant.name}: {ms:.4f} ms")
        if dkey is not None:
            _disk_store(path, dkey, results, done, complete=False)
    results = _default_first(results, a, b, config)
    # a partial ranking is not served: the next call resumes it
    if not out_of_budget:
        _attach(a, b, results, config)
    if dkey is not None and results:
        _disk_store(path, dkey, results, done, complete=not out_of_budget)
    return results


def _attach(a, b: torch.Tensor, results: List[TuneResult],
            config=None) -> None:
    if results:
        container_cache(a).setdefault("tune", {})[
            _tune_key(b, config)] = results


def spmm_tuned(a, b, config=None) -> torch.Tensor:
    """SpMM through the tuned winner for this (matrix, width, B dtype),
    tuning on first use.  Verified-only entries are skipped (a caller
    that checks each result, like the bench, picks from ``tune``'s
    ranking itself); with nothing left the dispatcher serves."""
    from tpuspmm_torch.config import default_config
    from tpuspmm_torch.engine.registry import get_engine
    from tpuspmm_torch.kernels import dispatch

    config = config or default_config()
    a = _as_tunable(a)
    b = _serving_operand(b, config)
    ranking = container_cache(a).get("tune", {}).get(_tune_key(b, config))
    if ranking is None:
        ranking = tune(a, b, config=config)
    ranking = [r for r in ranking if not r.verified_only]
    if not ranking:
        return dispatch.spmm_pallas(a, b, config)
    return get_engine(a.format_name).run_kernel(ranking[0].number, a, b,
                                                config)
