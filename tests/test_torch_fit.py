"""The port's cost-model tools: the NNLS fit against the JAX package's,
the H100 row of ``kernels/dispatch.py`` against the fit of its committed
records, and the ablation's records on the CPU."""

import json
import os

import numpy as np
import pytest

from bench.fit_panel_model import fit as jax_fit
from tpuspmm_torch.kernels import dispatch
from tpuspmm_torch.tools import ablate_panel, fit_panel_model, fit_routing
from tpuspmm_torch.tools.fit_panel_model import fit

RECORDS = os.path.join(os.path.dirname(fit_panel_model.__file__),
                       "ablate_panel_h100.jsonl")


def synthetic_records(true):
    rng = np.random.default_rng(0)
    records = []
    for tm in (8, 16, 32):
        for P in (16, 32, 64):
            for perm in (False, True):
                strips = int(rng.integers(500, 20000))
                steps = max(1, strips // P)
                sb = tm * 128 * 2
                m, n = 6300, 256
                us = (steps * true["step_us"]
                      + strips * sb / (true["gbps"] * 1e3)
                      + strips * true["strip_us"]
                      + (m * n * 8 / (true["gather_gbps"] * 1e3)
                         if perm else 0.0))
                records.append({
                    "kernel": "panel", "mode": "highest", "correct": True,
                    "perm": perm, "strips": strips, "steps": steps,
                    "strip_bytes": sb, "m": m, "n": n, "ms": us / 1e3})
    return records


def test_fit_recovers_synthetic_constants():
    true = dict(step_us=0.2, gbps=300.0, strip_us=0.02, gather_gbps=400.0)
    fitted, rms, used = fit(synthetic_records(true))
    assert used == 18 and rms < 1e-6
    assert fitted["panel_step_us"] == pytest.approx(0.2, rel=1e-3)
    assert fitted["panel_hbm_gbps"] == pytest.approx(300.0, rel=1e-2)
    assert fitted["panel_strip_us"] == pytest.approx(0.02, rel=1e-3)
    assert fitted["panel_gather_gbps"] == pytest.approx(400.0, rel=1e-2)


def test_fit_refuses_rank_deficient_and_short_records():
    rec = {"mode": "highest", "correct": True, "perm": False, "strips": 100,
           "steps": 10, "strip_bytes": 2048, "m": 100, "n": 64, "ms": 1.0}
    with pytest.raises(ValueError, match="rank-deficient"):
        fit([rec] * 6)
    with pytest.raises(ValueError, match="usable records"):
        fit([rec] * 3)
    # pair records, the split tier and gate misses are not fitted
    others = [dict(rec, kernel="pair"), dict(rec, mode="split2"),
              dict(rec, correct=False)] * 4
    with pytest.raises(ValueError, match="only 0"):
        fit(others)


@pytest.mark.parametrize("source", ["synthetic", "h100"])
def test_fit_matches_jax_tool(source):
    """The same records give the JAX package's fit (its tool fits every
    record it reads, so it is handed the panel records alone)."""
    if source == "synthetic":
        records = synthetic_records(dict(step_us=0.1, gbps=170.0,
                                         strip_us=0.003, gather_gbps=300.0))
    else:
        records = [r for r in fit_panel_model.read_records([RECORDS])
                   if r.get("kernel") == "panel"]
    mine, rms, n = fit(records)
    theirs, jrms, jn = jax_fit(records)
    assert mine == theirs and n == jn and rms == pytest.approx(jrms)


def test_h100_row_is_the_fit_of_the_committed_records():
    records = fit_panel_model.read_records([RECORDS])
    assert records[0]["card"].startswith("NVIDIA H100")
    assert records[0]["timer"] == "cuda_graph"
    fitted, rms, used = fit(records)
    for key, value in fitted.items():
        if value is None:  # not identifiable: measured directly instead
            assert key in fit_routing.CONSTANTS
        else:
            assert dispatch.H100_FIT[key] == value
    # the rest of the row is tools/fit_routing.py's: the routing constants
    # and the serve-time model
    assert set(dispatch.H100_FIT) == {k for k, v in fitted.items()
                                      if v is not None} | set(
        fit_routing.CONSTANTS) | {k for terms in
                                  dispatch.SERVE_TERMS.values()
                                  for k in terms}
    assert used == 55 and round(rms, 4) == 0.0885


def test_fit_tool_prints_one_line(capsys):
    assert fit_panel_model.main([RECORDS]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["records_used"] == 55
    assert out["fitted"]["panel_step_us"] == dispatch.H100_FIT[
        "panel_step_us"]


def test_ablate_panel_on_the_cpu(capsys):
    """Well-formed records on small_32x32: the card line, then panel
    records at both tiers and pair records, each with the fit's keys."""
    assert ablate_panel.main(["small_32x32", "--width", "32", "--device",
                              "cpu", "--tm", "8,16", "--natural",
                              "--repeats", "2"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[0]["card"] == "cpu" and lines[0]["timer"] == "host"
    recs = lines[1:]
    panel = [r for r in recs if r["kernel"] == "panel"]
    pair = [r for r in recs if r["kernel"] == "pair"]
    assert {r["geom"] for r in panel} == {"auto", "P16", "P32", "P64",
                                          "tm8", "tm16", "natural"}
    assert {r["mode"] for r in panel} == {"highest", "split2"}
    assert len(pair) == ablate_panel.PAIR_CANDIDATES
    for r in recs:
        assert r["correct"] is True and r["timer"] == "host"
        assert all(k in r for k in fit_panel_model.KEYS + (
            "perm", "cost_us", "vendor_ms", "mode"))
        assert r["ms"] > 0 and r["strips"] >= r["steps"] >= 1
