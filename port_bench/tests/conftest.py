"""CPU tests of the benchmark at tiny sizes:

    python -m pytest port_bench/tests -q

Tests marked `card` need an NVIDIA card; they decide inside the test
whether there is one and skip here."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PB = os.path.join(ROOT, "port_bench")

# a tiny stand-in of the configuration: the same keys and model, and
# one tiny cell for each of its cells
TINY = {"tiny": ("mrsa-2282", dict(n=62, genome_bp=5003))}
TINY_CELLS = {"tiny.tree": ("tiny", "tree", 4),
              "tiny.dist": ("tiny", "dist", 2),
              "tiny.tree-b": ("tiny", "tree-b", 4)}
REAL_CELL = {"tiny.tree": "mrsa2282.tree", "tiny.dist": "mrsa2282.dist",
             "tiny.tree-b": "mrsa2282.tree-b"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


def tiny_config(name: str) -> dict:
    base, over = TINY[name]
    with open(os.path.join(PB, "configs", base + ".json")) as fh:
        cfg = json.load(fh)
    cfg.update(over, name=name)
    return cfg


def tiny_benchmark() -> dict:
    """BENCHMARK.json with the tiny cells in place of the real ones,
    each declaring the metrics of the cell it stands for."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    real = {v: k for k, v in REAL_CELL.items()}
    b["workloads"] = [dict(w, name=real[w["name"]],
                           config=TINY_CELLS[real[w["name"]]][0])
                      for w in b["workloads"]]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real[w] for w in m["workloads"]]
    return b


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A copy of the benchmark's data folders with the tiny cells added
    and declared in a BENCHMARK.json beside it, and the program on the
    CPU."""
    root = tmp_path / "port_bench"
    for d in ("metrics", "roofline", "traffic", "configs", "workloads"):
        shutil.copytree(os.path.join(PB, d), root / d)
    for name in TINY:
        (root / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(name)))
    for cell, (cfg, traffic, check) in TINY_CELLS.items():
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": cfg, "traffic": traffic, "chips": 1,
             "check": check}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(tiny_benchmark()))
    monkeypatch.setenv("CCPHYLO_TORCH_DEVICE", "cpu")
    return root


def run_cell(root, capsys, *argv) -> dict:
    """One harness run on the CPU; its result line."""
    import time
    import torch
    from port_bench.harness import main
    rc = main(list(argv), time.perf_counter(), root=str(root),
              dev=torch.device("cpu"))
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, out
    return json.loads(out[-1])
