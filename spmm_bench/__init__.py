"""The benchmark of ``tpuspmm_torch``: ``tpuspmm_torch.spmm`` served step by
step on the card, one cell of ``BENCHMARK.json`` a run.

Run a cell from the repository root::

    python3 -m spmm_bench.run --workload n4c6_b13.fresh_b_w256 \\
        --seed 12345 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name in ``BENCHMARK.json``:
``configs/<config>.json`` (the operands and where they come from),
``generators/<kind>.py`` (how a kind of operand is made or read, with
``build(config, seed, device, root)``), ``traffic/<mix>.json`` (B's width,
dtype, pool and the calls of a step) and ``metrics/<metric>.py`` (a reader
with ``read(ctx)``).  The yardstick is
the benchmark's own: the operation and byte counts and the table of peaks
(``counts.py``), the plain reference (``reference.py``) and the reading of
the profiler's trace (``trace.py``) import nothing of the program.
"""
