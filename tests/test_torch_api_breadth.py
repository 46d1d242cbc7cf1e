"""The rest of the port's API against tpuspmm's: spmv, spmm_batched,
spmm_transpose and spmm_fn's gradient, the exported names, the CLI's
--tuned and --trace, and the headline bench on the CPU.

The same seeded inputs go through both packages, method "xla" on both
sides and the port's "auto" (its kernels' plain versions on a CPU tensor)
against JAX's "pallas" in interpret mode.  Each result is within
1e-5·max|C| of JAX's and passes the rel 1e-2 / abs 1e-3 gate against the
f64 oracle.
"""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import tpuspmm
import tpuspmm_torch
from tpuspmm_torch import bench, cli, interop
from tpuspmm_torch.config import Config
from tpuspmm_torch.utils.compare import allclose
from tpuspmm_torch.utils.profiling import TRACE_FILE

CPU = Config(device="cpu")
METHODS = [("xla", "xla"), ("auto", "pallas")]  # (port, JAX)
M, K = 160, 224


@pytest.fixture(autouse=True)
def no_disk_cache(monkeypatch):
    monkeypatch.delenv("TPUSPMM_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.delenv("TPUSPMM_TORCH_GEOM_CACHE", raising=False)


@pytest.fixture(scope="module")
def mats():
    """(JAX CSR, port CSR, scipy f64 matrix) of one seeded matrix."""
    rng = np.random.default_rng(0)
    sp = scipy.sparse.random(M, K, density=0.04, format="csr",
                             random_state=rng,
                             data_rvs=lambda n: rng.uniform(-1, 1, n))
    sp.data = sp.data.astype(np.float32)
    return (tpuspmm.CSR.from_scipy(sp),
            interop.csr_from_arrays(sp.indptr, sp.indices, sp.data,
                                    sp.shape),
            sp.astype(np.float64))


def uniform(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def held(got, ref, exact):
    """Within 1e-5·max|C| of JAX's result, and at the gate against the
    f64 oracle."""
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert allclose(got, exact) and allclose(ref, exact)


@pytest.mark.parametrize("method,jmethod", METHODS)
def test_spmv_matches_jax(mats, method, jmethod):
    ja, ta, sp = mats
    x = uniform(K, 1)
    got = tpuspmm_torch.spmv(ta, torch.from_numpy(x), method=method,
                             config=CPU)
    assert got.shape == (M,) and got.dtype == torch.float32
    held(got, tpuspmm.spmv(ja, x, method=jmethod), sp @ x.astype(np.float64))
    x16 = torch.from_numpy(x).to(torch.bfloat16)  # 2-byte B rows
    got16 = tpuspmm_torch.spmv(ta, x16, method=method, config=CPU)
    assert allclose(got16, sp @ x16.double().numpy())


@pytest.mark.parametrize("method,jmethod", METHODS)
def test_spmm_batched_matches_jax(mats, method, jmethod):
    ja, ta, sp = mats
    b = uniform((2, 3, K, 40), 2)
    got = tpuspmm_torch.spmm_batched(ta, torch.from_numpy(b), method=method,
                                     config=CPU)
    assert got.shape == (2, 3, M, 40)
    ref = tpuspmm.spmm_batched(ja, b, method=jmethod)
    exact = np.einsum("mk,...kn->...mn", sp.toarray(), b.astype(np.float64))
    held(got, ref, exact)
    with pytest.raises(ValueError, match="K=224"):
        tpuspmm_torch.spmm_batched(ta, torch.zeros(2, K + 1, 8), config=CPU)


@pytest.mark.parametrize("method,jmethod", METHODS)
def test_spmm_transpose_matches_jax(mats, method, jmethod):
    ja, ta, sp = mats
    b = uniform((M, 72), 3)
    got = tpuspmm_torch.spmm_transpose(ta, torch.from_numpy(b),
                                       method=method, config=CPU)
    held(got, tpuspmm.spmm_transpose(ja, b, method=jmethod),
         sp.T @ b.astype(np.float64))
    at = tpuspmm_torch.ops.api.transposed(ta)
    assert at is tpuspmm_torch.ops.api.transposed(ta)  # cached on A
    assert at.shape == (K, M) and at.row_sorted


@pytest.mark.parametrize("method,jmethod", METHODS)
def test_spmm_fn_gradient_matches_jax_grad(mats, method, jmethod):
    ja, ta, sp = mats
    b, g = uniform((K, 48), 4), uniform((M, 48), 5)
    jf = tpuspmm.spmm_fn(ja, method=jmethod)
    ref_grad = jax.grad(lambda bb: jnp.sum(jf(bb) * jnp.asarray(g)))(
        jnp.asarray(b))
    leaf = torch.from_numpy(b).requires_grad_(True)
    c = tpuspmm_torch.spmm_fn(ta, method=method, config=CPU)(leaf)
    held(c, jf(jnp.asarray(b)), sp @ b.astype(np.float64))
    (c * torch.from_numpy(g)).sum().backward()
    held(leaf.grad, ref_grad, sp.T @ g.astype(np.float64))


def test_spmm_fn_bf16_gradient_in_b_dtype(mats):
    _, ta, sp = mats
    leaf = torch.from_numpy(uniform((K, 32), 6)).to(
        torch.bfloat16).requires_grad_(True)
    c = tpuspmm_torch.spmm_fn(ta, config=CPU)(leaf)
    assert c.dtype == torch.float32
    g = uniform((M, 32), 7)
    c.backward(torch.from_numpy(g))
    assert leaf.grad.dtype == torch.bfloat16
    assert allclose(leaf.grad, sp.T @ g.astype(np.float64))


def test_exports_match_jax():
    assert set(tpuspmm.__all__) <= set(tpuspmm_torch.__all__)
    assert tpuspmm_torch.FORMATS == tpuspmm.FORMATS
    assert [v.name for v in tpuspmm_torch.get_engine("csr").variants] == [
        v.name for v in tpuspmm.get_engine("csr").variants]


def run_cli(args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        status = cli.main(args)
    recs = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]
    return status, recs, err.getvalue()


def test_cli_tuned(small32_dir):
    status, recs, err = run_cli(["--csr", "--coo", "--tuned", "-d",
                                 small32_dir, "--device", "cpu",
                                 "--repeats", "1"])
    assert status == 0 and len(recs) == 2
    for rec in recs:
        assert rec["tuned"] == "1" and rec["correct"] == "1"
        names = [r["kernel"] for r in rec["ranking"]]
        assert rec["kernelName"] == names[0]
        assert "torch_sparse_csr" in names
        assert rec["device"] == "cpu" and "gflops" not in rec
    assert "# tune:" in err


def test_cli_trace(small32_dir, tmp_path):
    status, recs, _ = run_cli(["--csr", "--kernel", "7", "-d", small32_dir,
                               "--device", "cpu", "--trace",
                               str(tmp_path / "trace")])
    assert status == 0 and recs[0]["correct"] == "1"
    events = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())
    assert any("aten::" in e.get("name", "")
               for e in events["traceEvents"])


BENCH_KEYS = {"metric", "kernel", "value", "unit", "vs_baseline",
              "kernel_ms", "vendor_ms", "nnz_per_s", "hbm_roofline_frac",
              "correct", "bf16_serving_ms", "bf16_serving_correct",
              "backend", "device_ms", "default_serve_ms", "bCols",
              "bDtype", "bSource"}


def test_bench_prints_one_json_line(capsys):
    status = bench.main(["--device", "cpu", "--data-dir", "small_32x32",
                         "--width", "32", "--repeats", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert status == 0 and len(out) == 1
    rec = json.loads(out[0])
    assert BENCH_KEYS <= set(rec)
    assert rec["correct"] and rec["bf16_serving_correct"]
    assert rec["backend"] == "cpu" and rec["device_ms"] is None
    assert rec["hbm_roofline_frac"] is None
    assert rec["kernel"] != "torch_sparse_csr"
    assert rec["metric"] == "csr_spmm_gflops_small_32x32_w32"


def test_bench_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench.main([]) == 2
