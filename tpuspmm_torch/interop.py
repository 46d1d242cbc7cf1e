"""Containers and plans from plain numpy arrays.

With these, a plan that another implementation built (for example
``tpuspmm``'s, handed over as numpy arrays) is served by this package's
kernels unchanged.  A bf16 ``a_dense`` arrives as its uint16 bit pattern,
which is how this package stores a bf16 plan.
"""

from __future__ import annotations

import numpy as np

from tpuspmm_torch.formats import CSR
from tpuspmm_torch.formats.tiles import TilePlan
from tpuspmm_torch.kernels.pair_spmm import PairPlan
from tpuspmm_torch.kernels.panel_spmm import PanelPlan


def _i32(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int32)


def _plan_values(a_dense) -> np.ndarray:
    a_dense = np.ascontiguousarray(a_dense)
    if a_dense.dtype not in (np.float32, np.uint16):
        raise ValueError("a_dense must be float32 or uint16 bf16 bits, got "
                         f"{a_dense.dtype}")
    return a_dense


def _perm(row_perm):
    return None if row_perm is None else np.asarray(row_perm, np.int64)


def csr_from_arrays(indptr, indices, values, shape) -> CSR:
    return CSR(indptr=_i32(indptr), indices=_i32(indices),
               values=np.ascontiguousarray(values, dtype=np.float32),
               shape=tuple(int(s) for s in shape))


def panel_plan_from_arrays(kt, st, offs, a_dense, shape, tm, tk, P, sm,
                           row_perm=None) -> PanelPlan:
    return PanelPlan(kt=_i32(kt), st=_i32(st), offs=_i32(offs),
                     a_dense=_plan_values(a_dense),
                     shape=tuple(int(s) for s in shape), tm=int(tm),
                     tk=int(tk), panel_strips=int(P), sm=int(sm),
                     row_perm=_perm(row_perm))


def pair_plan_from_arrays(kt, st, start, count, offs, a_dense, shape, tm,
                          tk, CH, sm, row_perm=None) -> PairPlan:
    return PairPlan(kt=_i32(kt), st=_i32(st), start=_i32(start),
                    count=_i32(count), offs=_i32(offs),
                    a_dense=_plan_values(a_dense),
                    shape=tuple(int(s) for s in shape), tm=int(tm),
                    tk=int(tk), chunk_strips=int(CH), sm=int(sm),
                    row_perm=_perm(row_perm))


def tile_plan_from_arrays(rt, kt, first, rows, cols, vals, shape, tile_m,
                          tile_k, chunk) -> TilePlan:
    return TilePlan(rt=_i32(rt), kt=_i32(kt), first=_i32(first),
                    rows=_i32(rows), cols=_i32(cols),
                    vals=np.ascontiguousarray(vals, dtype=np.float32),
                    shape=tuple(int(s) for s in shape), tile_m=int(tile_m),
                    tile_k=int(tile_k), chunk=int(chunk))


def tile_plan_arrays(plan: TilePlan) -> dict:
    """The fields of a TilePlan as numpy arrays and ints, the keyword
    arguments of another implementation's TilePlan."""
    return {"rt": plan.rt, "kt": plan.kt, "first": plan.first,
            "rows": plan.rows, "cols": plan.cols, "vals": plan.vals,
            "shape": tuple(plan.shape), "tile_m": plan.tile_m,
            "tile_k": plan.tile_k, "chunk": plan.chunk}
