"""The JSON files the autotuner's rankings and the pinned panel / pair
geometries persist in (``engine/autotune.py``, ``kernels/panel_spmm.py``).

Each file maps a key string to an entry.  A file is the variable's path
when it is set, else one under ``~/.cache/tpuspmm_torch/`` for a CUDA
device; for a CPU device with the variable unset there is no file, since a
ranking or geometry timed on the CPU means nothing on the card.  The JAX
package's files (``~/.cache/tpuspmm/``) are never read.  Both files key a
matrix by :func:`matrix_digest`.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from tpuspmm_torch.formats.base import container_cache


def cache_path(var: str, name: str, device) -> str | None:
    """``$var`` if set; else ~/.cache/tpuspmm_torch/``name`` for a CUDA
    device, and None for a CPU one."""
    path = os.environ.get(var)
    if path:
        return path
    if torch.device(device).type == "cpu":
        return None
    return os.path.join(os.path.expanduser("~"), ".cache", "tpuspmm_torch",
                        name)


def read(path: str | None) -> dict:
    """The file's entries; {} when there is no file or it does not parse
    (the next write replaces it)."""
    if path is None:
        return {}
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def write(path: str, key: str, entry) -> None:
    """Set ``key`` in the file: the whole file goes to a temporary file
    that is then moved into place, so a killed process never leaves it
    truncated."""
    data = read(path)
    data[key] = entry
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def matrix_digest(a) -> str:
    """Fingerprint of a container's structure and values over the full
    arrays (a prefix would let two matrices share a ranking), cached on
    it."""
    cache = container_cache(a)
    if "matrix_digest" not in cache:
        h = hashlib.sha1(repr((a.format_name, tuple(a.shape), int(a.nnz),
                               getattr(a, "block_size", None))).encode())
        for name in ("indptr", "indices", "rows", "cols", "values", "blocks",
                     "rowind"):
            arr = getattr(a, name, None)
            if arr is not None:
                h.update(np.ascontiguousarray(np.asarray(arr)).data)
        cache["matrix_digest"] = h.hexdigest()[:16]
    return cache["matrix_digest"]
