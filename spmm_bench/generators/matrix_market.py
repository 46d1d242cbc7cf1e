"""Operands of kind ``matrix_market``: one CSR read with scipy from the
configuration's ``operands.path`` (relative to the root); its values are
the file's, whatever the seed."""

from __future__ import annotations

import os

import numpy as np
import torch

from spmm_bench.operands import Operand


def build(config: dict, seed: int, device, root: str) -> list:
    import scipy.io

    spec = config["operands"]
    m = scipy.io.mmread(os.path.join(root, spec["path"])).tocsr()
    m.sum_duplicates()
    return [Operand(
        name=spec.get("name", config["name"]), shape=tuple(m.shape),
        indptr=torch.from_numpy(m.indptr.astype(np.int64)).to(device),
        indices=torch.from_numpy(m.indices.astype(np.int64)).to(device),
        values=torch.from_numpy(m.data.astype(np.float32)).to(device))]
