"""Finds a cell's pieces by name: configs/<name>.json,
workloads/<name>.json, traffic/<name>.json, seams/<seam>.py and one
reader metrics/<metric>.py per per-layer metric.  Adding any of them is
adding a file."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _json(root: str, kind: str, name: str) -> dict:
    path = os.path.join(root, kind, name + ".json")
    with open(path) as fh:
        return json.load(fh)


def cell(name: str, root: str = HERE) -> tuple:
    """(workload, config, traffic) dicts of the cell `name`."""
    wl = _json(root, "workloads", name)
    return wl, _json(root, "configs", wl["config"]), \
        _json(root, "traffic", wl["traffic"])


def declared(cell: str, root: str = HERE):
    """The metrics BENCHMARK.json (beside the benchmark's folder)
    declares for `cell`, or None where it does not declare the cell."""
    path = os.path.join(os.path.dirname(root), "BENCHMARK.json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        b = json.load(fh)
    if cell not in {w["name"] for w in b["workloads"]}:
        return None
    return {m["name"] for m in b["end_to_end"] + b["per_layer"]
            if cell in m.get("workloads", [cell])}


def seam(name: str):
    """The Seam class of seams/<name>.py."""
    return importlib.import_module(f"port_bench.seams.{name}").Seam


def readers(root: str = HERE) -> dict:
    """metric name -> read(ctx) of every metrics/<name>.py."""
    out = {}
    folder = os.path.join(root, "metrics")
    for fn in sorted(os.listdir(folder)):
        if not fn.endswith(".py") or fn.startswith("_"):
            continue
        name = fn[:-3]
        spec = importlib.util.spec_from_file_location(
            f"port_bench_metric_{len(out)}", os.path.join(folder, fn))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out
