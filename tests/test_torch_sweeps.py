"""tpuspmm_torch's sweeps and the pruned-MLP example against the JAX
package's ``bench/`` and ``examples/``.

- ``sweep_formats`` on small_10x10 and ``sweep_sparsity`` on 64 × 64
  matrices (``--device cpu``: the plain versions) give the JAX sweeps' set of
  (format, kernelType, kernelName, correct, skipped) and their record
  keys, the JAX side run as its tests run it (Pallas interpret mode).  The
  keys differ only by the documented renames: the reference's
  ``cuda*TimeMs`` for ``tpu*TimeMs``, ``device`` for ``backend`` /
  ``chip``, no throughput from a CPU clock, and the port's provenance.
- A variant that raises gives an error record and exit 1; a CUDA error
  gives a faulted group and exit 2 after its retries, and a retried
  group's records carry ``retried``; ``--isolate`` marks a group whose
  child never completed.
- ``splice_sweep`` and ``summarize`` give ``bench/``'s output on the same
  JSONL; ``summarize`` reads the port's own records too.
- ``pruned_llm`` runs every BSR variant of the JAX registry at the gate;
  ``pruned_mlp`` passes its gate in f32 and bf16, also ``--sharded`` at
  one rank; every entry point exits 2 with no card.
- No new module imports ``jax`` or ``tpuspmm``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from bench import splice_sweep as jsplice
from bench import summarize as jsummarize
from bench import sweep_formats as jsweep_formats
from bench import sweep_sparsity as jsweep_sparsity
from tpuspmm.engine import registry as jregistry
from tpuspmm_torch.engine import registry
from tpuspmm_torch.examples import pruned_mlp
from tpuspmm_torch.sweeps import (pruned_llm, splice_sweep, summarize,
                                  sweep_formats, sweep_sparsity)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")

# JAX's record keys that the port names otherwise or does not write on a
# CPU device, and the port's own
RENAMED = {"tpuPrologTimeMs": "cudaPrologTimeMs",
           "tpuKernelTimeMs": "cudaKernelTimeMs",
           "tpuEpilogTimeMs": "cudaEpilogTimeMs",
           "tpuTotalTimeMs": "cudaTotalTimeMs", "backend": "device",
           "chip": "device"}
CPU_CLOCK_RATES = {"gflops", "hbmRooflineFraction", "nnzPerSec"}
PORT_ONLY = {"timer", "blockStream", "residency"}


def quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()) as err:
        status = fn(argv)
    return status, out.getvalue(), err.getvalue()


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.startswith("{")]


def outcome(recs):
    """(format, number, name, correct, skipped), the vendor by number."""
    return {(r["format"], r["kernelType"],
             "vendor" if r["kernelType"] == "-1" else r["kernelName"],
             r["correct"], r.get("skipped")) for r in recs}


def keys(recs, mapping=None):
    out = set()
    for r in recs:
        out |= {(mapping or {}).get(k, k) for k in r}
    return out


def same_as_jax(mine, theirs):
    assert outcome(mine) == outcome(theirs)
    assert keys(theirs, RENAMED) - CPU_CLOCK_RATES == keys(mine) - PORT_ONLY


def test_sweep_formats_matches_jax(tmp_path):
    argv = ["--data-root", DATA, "--dirs", "small_10x10", "--repeats", "1",
            "--retries", "0", "--fresh"]
    status, _, err = quiet(jsweep_formats.main,
                           argv + ["--out", str(tmp_path / "j.jsonl")])
    assert status == 0, err
    status, _, err = quiet(sweep_formats.main,
                           argv + ["--out", str(tmp_path / "t.jsonl"),
                                   "--device", "cpu"])
    assert status == 0, err
    mine, theirs = records(tmp_path / "t.jsonl"), records(tmp_path / "j.jsonl")
    same_as_jax(mine, theirs)
    assert {r["format"] for r in mine} == {"csr", "coo", "bsr", "ell"}
    assert all(r["device"] == "cpu" and r["bSource"] == "ondisk"
               for r in mine)


def test_sweep_sparsity_matches_jax(tmp_path):
    argv = ["--rows", "64", "--cols", "64", "--width", "32", "--densities",
            "0.3", "--repeats", "1", "--fresh"]
    status, _, err = quiet(jsweep_sparsity.main,
                           argv + ["--out", str(tmp_path / "j.jsonl")])
    assert status == 0, err
    status, _, err = quiet(sweep_sparsity.main,
                           argv + ["--out", str(tmp_path / "t.jsonl"),
                                   "--device", "cpu"])
    assert status == 0, err
    mine, theirs = records(tmp_path / "t.jsonl"), records(tmp_path / "j.jsonl")
    same_as_jax(mine, theirs)
    assert {r["testcase"] for r in mine} == {"sp_0.3_64x64"}
    assert {(r["testcase"], r["sparsity"]) for r in mine} == \
        {(r["testcase"], r["sparsity"]) for r in theirs}


@pytest.mark.parametrize("message, status, retried", [
    ("ValueError: boom", 1, None),
    ("CUDA error: an illegal memory access was encountered", 2, 1),
])
def test_error_and_fault_records_set_the_exit(tmp_path, monkeypatch,
                                              message, status, retried):
    """An error record fails the sweep (1); a CUDA error faults its group
    (2), which is run again (``--retries 1``) and marked ``retried``."""
    engine = registry.get_engine("csr")
    victim = next(v for v in engine.variants if v.name == "pallas_tile_mxu")

    def broken(a, b, config):
        raise RuntimeError(message)

    monkeypatch.setattr(victim, "fn", broken)
    out = tmp_path / "t.jsonl"
    got, _, err = quiet(sweep_formats.main, [
        "--data-root", DATA, "--dirs", "small_10x10", "--formats", "csr",
        "--repeats", "1", "--retries", "1", "--device", "cpu", "--out",
        str(out), "--fresh"])
    assert got == status, err
    recs = records(out)
    bad = [r for r in recs if r["kernelName"] == "pallas_tile_mxu"]
    assert len(bad) == 1 and message in bad[0]["error"]
    assert ("device_fault" in bad[0]) == (status == 2)
    assert all(r.get("retried") == retried for r in recs)
    if status == 2:  # nothing ran after the fault
        assert recs[-1] is not None and recs[-1]["kernelName"] == \
            "pallas_tile_mxu"


def test_isolate_marks_a_group_that_never_completed(tmp_path, monkeypatch):
    """Each (dir, format) in a child; a child that exits 2 is run again,
    its last attempt's records kept with ``retried`` and the group marked
    ``sweep_incomplete``; the parent exits 2."""
    calls = []

    def fake_run(cmd):
        part = cmd[cmd.index("--out") + 1]
        fmt = cmd[cmd.index("--formats") + 1]
        calls.append(fmt)
        with open(part, "w") as f:
            f.write(json.dumps({"testcase": "small_10x10", "format": fmt,
                                "kernelType": "1", "correct": "1"}) + "\n")
        return subprocess.CompletedProcess(cmd, 2 if fmt == "coo" else 0)

    monkeypatch.setattr(sweep_formats.subprocess, "run", fake_run)
    out = tmp_path / "t.jsonl"
    status, _, _ = quiet(sweep_formats.main, [
        "--data-root", DATA, "--dirs", "small_10x10", "--formats", "csr,coo",
        "--isolate", "--retries", "1", "--out", str(out), "--fresh"])
    assert status == 2 and calls == ["csr", "coo", "coo"]
    recs = records(out)
    assert recs[0] == {"testcase": "small_10x10", "format": "csr",
                       "kernelType": "1", "correct": "1"}
    assert recs[1]["retried"] == 1
    assert recs[2] == {"testcase": "small_10x10", "format": "coo",
                       "sweep_incomplete": "1", "child_rc": 2}
    assert not any(p.endswith(".part") for p in os.listdir(tmp_path))


def test_summarize_matches_bench_on_jax_records(capsys):
    """The same table and tally as bench/summarize.py on the JAX sweep's
    committed records (their times are ``tpuKernelTimeMs``)."""
    path = os.path.join(REPO, "results", "formats_full.jsonl")
    outs = []
    for fn in (jsummarize.main, summarize.main):
        status = fn([path, "--csv"])
        outs.append((status, capsys.readouterr()))
    assert outs[0] == outs[1]
    for fn in (jsummarize.summarize, summarize.summarize):
        rows = fn(jsummarize.load([path]))
    assert rows == jsummarize.summarize(jsummarize.load([path]))


def test_summarize_reads_the_ports_records(tmp_path):
    recs = [
        {"testcase": "d", "format": "csr", "kernelType": "0",
         "kernelName": "oracle_numpy_f64", "correct": "1",
         "cudaKernelTimeMs": 9.0, "bCols": 8, "bDtype": "f32"},
        {"testcase": "d", "format": "csr", "kernelType": "2",
         "kernelName": "pallas_tile_mxu", "correct": "1",
         "cudaKernelTimeMs": 0.05, "gflops": 3.0, "bCols": 8,
         "bDtype": "f32"},
        {"testcase": "d", "format": "csr", "kernelType": "-1",
         "kernelName": "torch_sparse_csr", "correct": "1",
         "cudaKernelTimeMs": 0.1, "bCols": 8, "bDtype": "f32"},
        {"testcase": "d", "format": "csr", "kernelType": "6",
         "kernelName": "pallas_c_resident_split2", "correct": "0",
         "verifiedOnly": "1", "cudaKernelTimeMs": 0.01, "bCols": 8,
         "bDtype": "f32"},
        {"testcase": "d", "format": "csr", "kernelType": "3",
         "kernelName": "pallas_staged_b", "correct": "",
         "error": "RuntimeError: x", "bCols": 8, "bDtype": "f32"}]
    [row] = summarize.summarize(recs)
    assert (row["best_kernel"], row["best_ms"], row["vs_vendor"],
            row["incorrect"], row["vo_miss"], row["errored"]) == \
        ("pallas_tile_mxu", 0.05, 2.0, 0, 1, 1)


def test_splice_matches_bench(tmp_path):
    src = records(os.path.join(REPO, "results", "formats_full.jsonl"))[:60]
    part = [dict(r, rerun=1) for r in src if r.get("testcase") ==
            src[0]["testcase"] and r.get("format") == src[0]["format"]][:3]
    results = []
    for name, fn in (("j", jsplice.splice), ("t", splice_sweep.splice)):
        into, p = tmp_path / f"{name}.jsonl", tmp_path / f"{name}.part"
        into.write_text("".join(json.dumps(r) + "\n" for r in src))
        p.write_text("".join(json.dumps(r) + "\n" for r in part))
        results.append((fn(str(into), str(p)), into.read_text()))
    assert results[0] == results[1]
    assert results[1][0]["records_added"] == 3


def test_pruned_llm_runs_the_bsr_variants():
    status, out, err = quiet(pruned_llm.main, [
        "--dim", "256", "--width", "64", "--block-sparsity", "0.8,0.95",
        "--repeats", "1", "--b-dtype", "bf16", "--device", "cpu"])
    assert status == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert (line["dim"], line["block"], line["bDtype"], line["device"]) == \
        (256, 4, "bf16", "cpu")
    names = [v.name for v in jregistry.get_engine("bsr").variants]
    for bs in (0.8, 0.95):
        got = [r for r in line["results"] if r["block_sparsity"] == bs]
        assert [r["variant"] for r in got] == names
        for r in got:
            assert r.get("skipped") == "inadmissible" or r["correct"], r
            assert "gflops" not in r and r.get("device_ms") is None
    stream = [r for r in line["results"]
              if r["variant"] == "pallas_block_stream"]
    assert {r["blockStream"] for r in stream} == {"tile"}


@pytest.mark.parametrize("argv", [
    ["--activations-dtype", "f32"],
    ["--activations-dtype", "bf16"],
    ["--activations-dtype", "bf16", "--sharded"],
])
def test_pruned_mlp_passes_its_gate(argv):
    status, out, err = quiet(pruned_mlp.main, argv + [
        "--d-model", "128", "--d-ff", "256", "--batch", "16", "--device",
        "cpu"])
    assert status == 0, err
    assert f"'sharded': {'--sharded' in argv}" in out
    assert "'correct': True" in out


def test_pruned_mlp_bf16_holds_each_layer_to_its_served_operands():
    """At the default sizes a few bf16 roundings of h land apart from a
    dense f32 pipeline's (which is why each layer is held to the oracle of
    its served operands); the gate passes."""
    status, out, err = quiet(pruned_mlp.main, [
        "--activations-dtype", "bf16", "--device", "cpu"])
    assert status == 0, err
    apart = int(err.split(" h values rounded apart")[0].split(", ")[-1]
                .split(" of ")[0])
    assert apart > 0 and "'correct': True" in out


@pytest.mark.parametrize("main", [sweep_formats.main, sweep_sparsity.main,
                                  pruned_llm.main, pruned_mlp.main])
def test_no_card_exits_2(main, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    status, _, err = quiet(main, ["--dirs", "small_10x10"]
                           if main is sweep_formats.main else [])
    assert status == 2 and "no CUDA device" in err


NEW_MODULES = [
    "tpuspmm_torch.native", "tpuspmm_torch.native.fastio",
    "tpuspmm_torch.native.tileplan", "tpuspmm_torch.native.library",
    "tpuspmm_torch.tools.convert_mtx", "tpuspmm_torch.tools.gen_sparse",
    "tpuspmm_torch.tools.gen_matrix", "tpuspmm_torch.tools.validate",
    "tpuspmm_torch.tools.make_data", "tpuspmm_torch.tools.fetch_suitesparse",
    "tpuspmm_torch.sweeps", "tpuspmm_torch.sweeps.common",
    "tpuspmm_torch.sweeps.sweep_formats",
    "tpuspmm_torch.sweeps.sweep_sparsity", "tpuspmm_torch.sweeps.pruned_llm",
    "tpuspmm_torch.sweeps.summarize", "tpuspmm_torch.sweeps.splice_sweep",
    "tpuspmm_torch.examples.pruned_mlp"]


def test_new_modules_import_neither_jax_nor_tpuspmm():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['tpuspmm'] = None; import importlib\n"
            f"for m in {NEW_MODULES!r}: importlib.import_module(m)\n"
            "from tpuspmm_torch.formats import tiles, io\n"
            "from tpuspmm_torch import native\n"
            "print(native.available())")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
