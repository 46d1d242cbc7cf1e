"""The operands of a configuration, made or read by the benchmark itself.

``build(config, seed, device, root)`` returns the configuration's operands
in serving order, each as plain tensors on ``device`` (:class:`Operand`):
the program gets host copies of them (``system.py``), the reference makes
them again after the window.  The configuration's ``operands.kind`` names
the generator: ``spmm_bench/generators/<kind>.py`` under the root, whose
``build(config, seed, device, root)`` returns that list.  A new kind of
operand is a new file there, found by its name.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import os

import torch

from spmm_bench.counts import OperandCounts


def derived_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of draws (operands, B pools, samples)
    of a run's ``seed``, which may be any whole number."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(derived_seed(seed, stream))
    return g


@dataclasses.dataclass
class Operand:
    """One sparse operand: CSR (``block`` None; ``indptr`` over rows,
    ``indices`` a column a stored entry, ``values`` (nnz,)) or BSR
    (``indptr`` over block rows, ``indices`` a block column a block,
    ``values`` (blocks, bh, bw)); int64 indices, f32 values."""
    name: str
    shape: tuple
    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    block: tuple | None = None

    def counts(self) -> OperandCounts:
        rows, cols = self.shape
        touched = int(torch.unique(self.indices).numel())
        if self.block is not None:
            touched = min(cols, touched * self.block[1])
        return OperandCounts(rows=rows, cols=cols,
                             stored=int(self.values.numel()),
                             indices=int(self.indices.numel()),
                             pointers=int(self.indptr.numel()),
                             touched_cols=touched)


def generator_path(kind: str, root: str) -> str:
    return os.path.join(root, "spmm_bench", "generators", f"{kind}.py")


def build(config: dict, seed: int, device, root: str) -> list:
    """The configuration's operands, in serving order, on ``device``: the
    ``build`` of ``spmm_bench/generators/<operands.kind>.py`` under
    ``root``."""
    kind = config["operands"]["kind"]
    path = generator_path(kind, root)
    if not os.path.isfile(path):
        raise ValueError(f"unknown operand kind {kind!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        f"spmm_bench_generator_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build(config, seed, torch.device(device), root)
