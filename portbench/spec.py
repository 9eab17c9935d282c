"""Where the benchmark finds everything, by name.

- ``BENCHMARK.json`` at the checkout's root: the cells, their chips, and
  which metrics each cell reports (a metric with a ``workloads`` key in the
  cells it lists, one without it in every cell);
- ``portbench/workloads/<cell>.json``: the cell's entry point and traffic;
- the configuration's file, as ``BENCHMARK.json`` names it
  (``portbench/configs/<config>.json``);
- ``portbench/metrics/<metric>.py``: the metric's reader (a metric
  ``<base>.<group>`` with no file of its own reads as ``<base>``, in a
  group of cells with bounds of their own).

A cell, a configuration or a metric is added by adding its file and its
entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
METRIC_FIELDS = ("LAYER", "UNIT", "BETTER", "SOURCE")


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    """The ``BENCHMARK.json`` entry of cell ``name``; raises if none."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def workload(name: str) -> dict:
    with open(HERE / "workloads" / f"{name}.json") as f:
        return json.load(f)


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    with open(root / entry["file"]) as f:
        return json.load(f)


def cell_metrics(bench: dict, name: str, trace: bool) -> list[str]:
    """The metrics cell ``name`` reports: its end-to-end ones untraced, its
    per-layer ones traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m["name"] for m in group if name in m.get("workloads", [name])]


def metric(name: str):
    """The reader of metric ``name``: a module with ``LAYER``, ``UNIT``,
    ``BETTER``, ``SOURCE`` (and ``MOVES`` for a per-layer metric) and
    ``read(record)``, which returns a number or None where it finds
    nothing to read.

    ``<base>.<group>`` with no file of its own is ``<base>`` read in a group
    of cells that take bounds of their own (``mpix_per_s.b8``): the same
    reader, its ``MOVES`` (if any) in the same group."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        base, group = name.split(".", 1)
        reader = metric(base)
        fields = {f: getattr(reader, f) for f in (*METRIC_FIELDS, "read")}
        if hasattr(reader, "MOVES"):
            fields["MOVES"] = f"{reader.MOVES}.{group}"
        return types.SimpleNamespace(**fields)
    module = "portbench_metric_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(module, path)
    if spec is None or not path.is_file():
        raise KeyError(f"no reader for metric {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in (*METRIC_FIELDS, "read") if not hasattr(mod, f)]
    if missing:
        raise ValueError(f"metric reader {path} lacks {missing}")
    return mod
