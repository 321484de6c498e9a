"""Tiny stand-ins of the cells added after the benchmark's first three
(`tests/conftest.py` keeps those three): their configurations and cells,
and the stand-in BENCHMARK.json over every cell that the tests'
`tiny_root` fixture writes, so that each cell added as files is covered
by the tests of the cells before it."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.tests import conftest as first  # noqa: E402

MORE_TINY = {"tiny100k": ("dnj-100k", dict(n=90))}
MORE_CELLS = {"tiny100k.tree-b": ("tiny100k", "tree-b-u8", 2),
              "tiny.dist-pairwise": ("tiny", "dist-pairwise", 2)}
MORE_REAL = {"tiny100k.tree-b": "dnj100k.tree-b",
             "tiny.dist-pairwise": "mrsa2282.dist-pairwise"}


def tiny_config(name: str) -> dict:
    if name not in MORE_TINY:
        return first.tiny_config(name)
    base, over = MORE_TINY[name]
    with open(os.path.join(first.PB, "configs", base + ".json")) as fh:
        cfg = json.load(fh)
    cfg.update(over, name=name)
    return cfg


def tiny_benchmark() -> dict:
    """BENCHMARK.json with every cell replaced by its tiny stand-in,
    declaring the metrics of the cell it stands for."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    cells = {**first.TINY_CELLS, **MORE_CELLS}
    real = {v: k for k, v in {**first.REAL_CELL, **MORE_REAL}.items()}
    b["workloads"] = [dict(w, name=real[w["name"]],
                           config=cells[real[w["name"]]][0])
                      for w in b["workloads"]]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real[w] for w in m["workloads"]]
    return b


first.tiny_benchmark = tiny_benchmark
