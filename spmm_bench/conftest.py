"""Fixture data of the benchmark's tests that each configuration brings in
a file of its own.

``tests/test_spmm_bench_program_spans.py`` traces the tiny cells of
``tests/conftest.write_root`` in place of the real ones, through its table
``STANDS_FOR`` (configuration: tiny cell), for every configuration a
metric's ``workloads`` list names.  The configurations below are added to
that table once the tests are collected.
"""

# configuration: the tiny cell that stands for its cells
STANDS_FOR = {
    # pruned FFN weights at 128 x 128 blocks, bf16 B, as olmo_ffn_b128
    "dsv3_ep32_b128": "tiny_ffn.w16",
}


def pytest_collection_modifyitems(items):
    modules = {getattr(item, "module", None) for item in items}
    for module in modules:
        table = getattr(module, "STANDS_FOR", None)
        if isinstance(table, dict):
            for config, cell in STANDS_FOR.items():
                table.setdefault(config, cell)
