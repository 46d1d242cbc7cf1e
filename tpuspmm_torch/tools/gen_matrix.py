"""A small random dense matrix in the ``dense.in`` text format.

Counterpart of ``tpuspmm/tools/gen_matrix.py`` (the reference's
utils/python_utils/gen_matrix.py), with the same bytes.

Usage::

    python -m tpuspmm_torch.tools.gen_matrix OUT_PATH ROWS COLS [--seed 0]
        [--lo -1] [--hi 1]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out_path")
    p.add_argument("rows", type=int)
    p.add_argument("cols", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lo", type=float, default=-1.0)
    p.add_argument("--hi", type=float, default=1.0)
    args = p.parse_args(argv)

    from tpuspmm_torch.formats import io as fio

    rng = np.random.default_rng(args.seed)
    m = rng.uniform(args.lo, args.hi,
                    (args.rows, args.cols)).astype(np.float32)
    fio.write_dense_text(args.out_path, m)
    print(args.out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
