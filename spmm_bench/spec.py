"""A cell of ``BENCHMARK.json`` with the files it names, found by name.

A workload names a configuration (its ``file`` in ``configs``) and a
traffic mix (``spmm_bench/traffic/<traffic>.json``); the configuration's
operand kind is made by ``spmm_bench/generators/<kind>.py``
(``operands.build``); a metric of ``per_layer`` is read by
``spmm_bench/metrics/<name>.py``.  A metric with a
``workloads`` list belongs to those cells only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

from spmm_bench import traffic as traffic_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _read(os.path.join(root, "BENCHMARK.json"))


def _mine(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The workload ``name`` of ``root``'s BENCHMARK.json, with its
    configuration and traffic mix read and its metrics filtered to it."""
    bench = benchmark(root)
    try:
        work = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}") from None
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = _read(os.path.join(root, conf["file"]))
    config.setdefault("name", conf["name"])
    mix = traffic_mod.check(_read(os.path.join(
        root, "spmm_bench", "traffic", f"{work['traffic']}.json")))
    return Cell(name=name, chips=int(work["chips"]), config=config,
                traffic=mix,
                end_to_end=[m for m in bench["end_to_end"] if _mine(m, name)],
                per_layer=[m for m in bench["per_layer"] if _mine(m, name)])


def reader(metric: str, root: str = ROOT):
    """The ``read(ctx)`` of ``spmm_bench/metrics/<metric>.py``."""
    path = os.path.join(root, "spmm_bench", "metrics", f"{metric}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"spmm_bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
