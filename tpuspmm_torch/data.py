"""Benchmark-corpus resolution.

Directories resolve through ``$TPUSPMM_DATA`` when it is set, then the
repository's own ``data/`` tree (the same corpus ``tpuspmm.data`` serves).
"""

from __future__ import annotations

import os
from typing import Optional

_REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def data_roots() -> list:
    roots = []
    env = os.environ.get("TPUSPMM_DATA")
    if env:
        roots.append(env)
    roots.append(_REPO_DATA)
    return [r for r in roots if os.path.isdir(r)]


def data_dir(name: str) -> Optional[str]:
    """Absolute path of corpus directory `name`, or None if absent."""
    for root in data_roots():
        d = os.path.join(root, name)
        if os.path.isdir(d):
            return d
    return None
