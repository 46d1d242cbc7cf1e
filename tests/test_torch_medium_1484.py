"""medium_1484's f32 verdicts, pinned in both packages.

data/medium_1484 (1484 x 1484, 6,110 nonzeros, its on-disk f32 B) has
values up to 1.26e16 with cancellation, so whether an f32 sum passes the
gate against the f64 oracle (rel 1e-2 / abs 1e-3) depends on the order
of its terms, not on f32 accumulation as such: the correctly rounded f32
result passes.  Each variant's verdict is run through both packages on
the same operands (JAX's Pallas kernels in interpret mode, as
``tests/conftest.py`` sets it):

- where the port writes the order of summation itself (the gather path,
  the tile walk, the panel and pair ladders) its verdict equals JAX's:
  pass, pass, miss, miss;
- densify and the vendor product hand the sum to a library: both packages
  build the same operand (the dense f32 A, the summed triplets), and the
  verdicts differ by the library's product alone (XLA's dot and BCOO pass;
  ``torch.matmul`` and ``torch.sparse`` on the CPU miss);
- the port's default ``spmm`` routes the dir to the compensated ("exact")
  path and passes.
"""

import numpy as np
import pytest
import torch

from tpuspmm.data import data_dir
from tpuspmm.formats import convert as jconvert
from tpuspmm.formats.tiles import plan_from_container as jtile_plan
from tpuspmm.kernels import pair_spmm as jpair
from tpuspmm.kernels import panel_spmm as jpanel
from tpuspmm.kernels import tile_spmm as jtile
from tpuspmm.ops import oracle as joracle
from tpuspmm.ops import vendor as jvendor
from tpuspmm.ops import xla as jxla
from tpuspmm.utils.compare import allclose as jallclose

import tpuspmm_torch
from tpuspmm_torch.config import Config
from tpuspmm_torch.formats import convert as tconvert
from tpuspmm_torch.formats.tiles import plan_from_container as ttile_plan
from tpuspmm_torch.kernels import dispatch
from tpuspmm_torch.kernels import pair_spmm as tpair
from tpuspmm_torch.kernels import panel_spmm as tpanel
from tpuspmm_torch.kernels import tile_spmm as ttile
from tpuspmm_torch.ops import vendor as tvendor
from tpuspmm_torch.ops import xla as txla
from tpuspmm_torch.utils.compare import allclose as tallclose

NAME = "medium_1484"


@pytest.fixture(scope="module")
def operands():
    d = data_dir(NAME)
    if d is None:
        pytest.skip("corpus data not available")
    ja = jconvert.load_sparse(d, "csr")
    jb = np.asarray(jconvert.load_dense(d).data, dtype=np.float32)
    ta = tconvert.load_sparse(d, "csr")
    tb = np.asarray(tconvert.load_dense(d).data, dtype=np.float32)
    assert ja.shape == ta.shape == (1484, 1484) and ja.nnz == ta.nnz == 6110
    np.testing.assert_array_equal(jb, tb)
    ref = joracle.spmm_scipy_oracle(ja, jb)
    return ja, ta, jb, torch.from_numpy(tb), ref


def gate(out, ref) -> bool:
    """The reference gate (rel 1e-2, abs 1e-3) against the f64 oracle,
    the same verdict from either package's helper."""
    ok = jallclose(np.asarray(out), ref, 1e-2, 1e-3)
    assert ok == tallclose(np.asarray(out), ref)
    return ok


# variant: (JAX's call, the port's call, the verdict both give)
OWN_ORDER = {
    "xla_segment_sum": (lambda a, b: jxla.spmm_csr_xla(a, b),
                        lambda a, b: txla.spmm_csr_xla(a, b), True),
    "tile": (lambda a, b: jtile.spmm_tiles(jtile_plan(a), b),
             lambda a, b: ttile.spmm_tiles(ttile_plan(a), b), True),
    "panel": (lambda a, b: jpanel.spmm_panel(a, b),
              lambda a, b: tpanel.spmm_panel(a, b), False),
    "pair": (lambda a, b: jpair.spmm_pair(a, b),
             lambda a, b: tpair.spmm_pair(a, b), False),
}


@pytest.mark.parametrize("variant", list(OWN_ORDER))
def test_own_summation_verdict_equals_jax(operands, variant):
    """Where the port writes the order of summation, its verdict is
    JAX's: pass for the gather path and the tile walk, miss for the panel
    and pair ladders (f32 sums of 1e16-scale terms in strip order)."""
    ja, ta, jb, tb, ref = operands
    jax_fn, port_fn, want = OWN_ORDER[variant]
    assert gate(jax_fn(ja, jb), ref) is want
    assert gate(port_fn(ta, tb), ref) is want


def test_correctly_rounded_f32_passes(operands):
    """The f64 oracle rounded once to f32 passes: f32 output as such is
    not what misses."""
    *_, ref = operands
    assert gate(ref.astype(np.float32), ref)


def test_densify_differs_by_the_library_product(operands):
    """Both packages build the same dense f32 A (summed on the host in
    f64), bit for bit; XLA's HIGHEST dot of it passes, ``torch.matmul``
    (the CPU's BLAS) misses.  The f64 product of that operand passes, so
    the operand is sound and the verdicts differ by the library's order
    of summation alone."""
    ja, ta, jb, tb, ref = operands
    jax_out = jxla.spmm_densify_cached(ja, jb)
    port_out = txla.spmm_densify_cached(ta, tb)
    jax_dense = np.asarray(jxla.coo_view(ja)._xla_cache["dense_f32"])
    port_dense = txla.dense_f32(ta)
    assert jax_dense.dtype == port_dense.dtype == np.float32
    np.testing.assert_array_equal(jax_dense, port_dense)
    assert gate(jax_out, ref)
    assert not gate(port_out, ref)
    exact = port_dense.astype(np.float64) @ jb.astype(np.float64)
    assert gate(exact, ref)


def test_vendor_differs_by_the_library_product(operands):
    """BCOO and ``torch.sparse`` CSR hold the same summed triplets; JAX's
    BCOO product passes, ``torch.sparse`` on the CPU misses."""
    ja, ta, jb, tb, ref = operands
    bcoo = jvendor.to_bcoo(ja)
    idx = np.asarray(bcoo.indices)
    order = np.lexsort((idx[:, 1], idx[:, 0]))
    csr = tvendor.to_torch_csr(ta, "cpu")
    rows = np.repeat(np.arange(1484), np.diff(csr.crow_indices().numpy()))
    np.testing.assert_array_equal(idx[order, 0], rows)
    np.testing.assert_array_equal(idx[order, 1], csr.col_indices().numpy())
    np.testing.assert_array_equal(np.asarray(bcoo.data)[order],
                                  csr.values().numpy())
    assert gate(jvendor._bcoo_spmm(bcoo, jb), ref)
    assert not gate(tvendor.spmm_vendor(ta, tb), ref)


def test_default_spmm_routes_exact_and_passes(operands):
    """The port's default serve takes the compensated route there."""
    _, ta, _, tb, ref = operands
    assert dispatch.route(ta, tb) == "exact"
    assert gate(tpuspmm_torch.spmm(ta, tb, config=Config(device="cpu")), ref)
