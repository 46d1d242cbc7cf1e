"""SuiteSparse collection downloader.

Counterpart of ``tpuspmm/tools/fetch_suitesparse.py`` (the reference's
ssgetpy notebook, reference/utils/matrix_explorer.ipynb cells 10-12):
downloads ``GROUP/NAME`` in MatrixMarket form from sparse.tamu.edu (or
its mirror) and unpacks the ``.mtx`` files into a data directory for
``convert_mtx``.  It needs a network; without one it exits 3 with a
message (the corpus under ``data/`` serves the benchmarks offline).

Usage::

    python -m tpuspmm_torch.tools.fetch_suitesparse Hamrle/Hamrle1 \\
        -o data/hamrle1 [--convert]
"""

from __future__ import annotations

import argparse
import os
import sys
import tarfile
import tempfile
import urllib.request

BASE_URL = "https://suitesparse-collection-website.herokuapp.com/MM"
MIRROR_URL = "https://sparse.tamu.edu/MM"


def fetch(group_name: str, out_dir: str, timeout: float = 60.0) -> str:
    """Unpack GROUP/NAME's ``.mtx`` files into ``out_dir``; raises
    ConnectionError when no source answers."""
    group, name = group_name.split("/", 1)
    os.makedirs(out_dir, exist_ok=True)
    last_err = None
    for base in (MIRROR_URL, BASE_URL):
        url = f"{base}/{group}/{name}.tar.gz"
        try:
            with tempfile.NamedTemporaryFile(suffix=".tar.gz") as tmp:
                with urllib.request.urlopen(url, timeout=timeout) as resp:
                    tmp.write(resp.read())
                tmp.flush()
                with tarfile.open(tmp.name, "r:gz") as tar:
                    for member in tar.getmembers():
                        if member.isfile() and member.name.endswith(".mtx"):
                            member.name = os.path.basename(member.name)
                            tar.extract(member, out_dir, filter="data")
            return out_dir
        except (OSError, tarfile.TarError) as e:  # the next source
            last_err = e
    raise ConnectionError(
        f"could not fetch {group_name} from SuiteSparse ({last_err}); "
        "offline? the corpus under data/ serves the benchmarks without a "
        "network")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("matrix", help="GROUP/NAME, e.g. Hamrle/Hamrle1")
    p.add_argument("-o", "--out-dir", required=True)
    p.add_argument("--convert", action="store_true",
                   help="run convert_mtx on the directory afterwards")
    args = p.parse_args(argv)
    try:
        out = fetch(args.matrix, args.out_dir)
    except ConnectionError as e:
        print(str(e), file=sys.stderr)
        return 3
    print(out)
    if args.convert:
        from tpuspmm_torch.tools.convert_mtx import convert_dir

        for w in convert_dir(out):
            print(w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
