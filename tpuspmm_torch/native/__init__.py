"""Host (C++) code of the port: the text tokenizer and MatrixMarket reader
(``fastio.cpp``) and the tile-plan builder (``tileplan.cpp``), the port's
own copies of ``tpuspmm/native``'s sources.

Each is built with g++ at first use into ``build/tpuspmm_torch/``
(``native/library.NativeLibrary``: no ``-march=native``, named by the
hash of its source and flags) and bound with ctypes.  Where no g++ exists
the numpy / scipy paths serve, with the same results; the fallback is
visible: ``available()`` says whether both libraries load, and
``plan_builds`` counts the tile plans of ``formats/tiles.NATIVE_MIN_NNZ``
nonzeros or more by the path that built them ("native" or "numpy").
"""

from tpuspmm_torch.native.library import NativeUnavailable  # noqa: F401
from tpuspmm_torch.native import fastio, tileplan

plan_builds = {"native": 0, "numpy": 0}


def available() -> bool:
    """True when both host libraries build (or are built) and load."""
    return fastio.LIBRARY.available() and tileplan.LIBRARY.available()
