"""What the benchmark finds by name: the cells and metrics of
``BENCHMARK.json`` at the checkout's root, and beside this file one JSON
file a configuration (``configs/<name>.json``), a traffic mix
(``traffic/<name>.json``) and a cell's correctness limits
(``limits/<cell>.json``), and one reader a metric (``metrics/<name>.py``,
a function ``read(record)`` that gives a number or None).

A later cell, configuration, traffic mix or metric is a new file and a new
entry in ``BENCHMARK.json``: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    """The configuration's file, with ``scene`` made an absolute path."""
    cfg = _json(HERE, "configs", f"{name}.json")
    cfg["scene"] = os.path.join(HERE, "configs", cfg["scene"])
    return cfg


def traffic(name: str) -> dict:
    return _json(HERE, "traffic", f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json(HERE, "limits", f"{cell_name}.json")


def metrics_of(bench: dict, kind: str, cell_name: str) -> list:
    """The ``kind`` ('end_to_end' or 'per_layer') metrics a cell reports:
    those that list it, and those that list no cells."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = "cmr_bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
