"""Everything the harness runs is found by name: a cell in ``BENCHMARK.json``
and in ``port_bench/workloads/<cell>.json``, its configuration in the file
that ``BENCHMARK.json`` names, its traffic mix in
``port_bench/traffic/<mix>.json``, the mix's generator in
``port_bench/generators/<generator>.py`` and each metric's reader in
``port_bench/metrics/<metric>.py``. A later change adds a cell, a
configuration, a mix or a metric by adding files and entries, and edits
none."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType

__all__ = ["Cell", "ROOT", "BENCH_DIR", "cell_of", "load_benchmark", "load_cell", "metrics_for", "load_reader",
           "load_generator"]

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    """One cell: its entry in ``BENCHMARK.json``, its configuration, and
    ``params``, the traffic mix's parameters with the cell's own on top."""

    name: str
    entry: dict
    config: dict
    params: dict

    @property
    def generator(self) -> str:
        return self.params["generator"]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {', '.join(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell_of(entry, configs[entry["config"]]["file"], root)


def cell_of(entry: dict, config_file: str, root: str = ROOT) -> Cell:
    """The cell of a ``workloads`` entry whose configuration is in
    ``config_file`` (relative to ``root``)."""
    bench_dir = os.path.join(root, "port_bench")
    mix = _json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json"))
    own = _json(os.path.join(bench_dir, "workloads", f"{entry['name']}.json"))
    return Cell(entry["name"], entry, _json(os.path.join(root, config_file)), {**mix, **own})


def metrics_for(cell: str, trace: bool, root: str = ROOT) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``trace`` 0, the per-layer ones with 1; a metric with a ``workloads``
    list only in the cells it names."""
    bench = load_benchmark(root)
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, root: str = ROOT) -> ModuleType:
    """``port_bench/metrics/<metric>.py``: ``read(run) -> float | None``."""
    return _module(os.path.join(root, "port_bench", "metrics", f"{metric}.py"),
                   "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def load_generator(name: str, root: str = ROOT) -> ModuleType:
    """``port_bench/generators/<name>.py``: ``measure(ctx)`` and ``check(ctx, run)``."""
    return _module(os.path.join(root, "port_bench", "generators", f"{name}.py"),
                   "port_bench_generator_" + name.replace("-", "_"))
