"""What a run serves: the program, or the control in its place.

``Program`` is ``tpuspmm_torch`` through its public entry
``tpuspmm_torch.spmm(a, b)`` at the default config: ``prepare`` hands it
host copies of the benchmark's arrays as its CSR or BSR container, and the
route and launch counters are read from it for the record only.
``Control`` is the plain reference one precision step below the serve's
(``reference.CONTROLS``), which ``correct`` has to refuse.
"""

from __future__ import annotations

import sys

import numpy as np

from spmm_bench import reference


class Program:
    name = "tpuspmm_torch"

    def __init__(self):
        import tpuspmm_torch

        self._port = tpuspmm_torch
        self._spmm = tpuspmm_torch.spmm

    def prepare(self, op):
        indptr = op.indptr.cpu().numpy().astype(np.int32)
        indices = op.indices.cpu().numpy().astype(np.int32)
        values = np.ascontiguousarray(op.values.cpu().numpy(),
                                      dtype=np.float32)
        if op.block is None:
            return self._port.CSR(indptr=indptr, indices=indices,
                                  values=values, shape=tuple(op.shape))
        return self._port.BSR(indptr=indptr, indices=indices, blocks=values,
                              shape=tuple(op.shape),
                              block_size=tuple(op.block),
                              nnz=int(values.size))

    def spmm(self, handle, b):
        return self._spmm(handle, b)

    def route(self, handle, b) -> str:
        from tpuspmm_torch.kernels import dispatch

        return dispatch.route(handle, b)

    def counters(self) -> dict:
        """{module.entry: launches} of every hand-kernel entry loaded."""
        out = {}
        for name, mod in list(sys.modules.items()):
            if not name.startswith("tpuspmm_torch.") or mod is None:
                continue
            for attr, fn in vars(mod).items():
                count = getattr(fn, "launches", None)
                if callable(fn) and isinstance(count, int) and \
                        getattr(fn, "__module__", None) == name:
                    out[f"{name.rsplit('.', 1)[-1]}.{attr}"] = count
        return out


class Control:
    """The reference one precision step below the serve's (B's dtype):
    TF32 for f32 B, fp8 for bf16 B (``reference.CONTROLS``)."""
    name = "control"

    def prepare(self, op):
        return op

    @staticmethod
    def _control(b):
        return reference.CONTROLS[str(b.dtype).split(".")[-1]]

    def spmm(self, op, b):
        return reference.product(op, b, control=self._control(b)[1])

    def route(self, op, b) -> str:
        return f"reference at {self._control(b)[0]}"

    def counters(self) -> dict:
        return {}
