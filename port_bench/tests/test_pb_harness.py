"""The harness on the CPU at tiny sizes: a whole run of each tiny cell,
the discovery of cells, configurations and metrics dropped in as files,
the faults that must make `correct` false, the controls, the trace's
reduction, and the chip check."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from port_bench import registry, trace
from port_bench.tests.conftest import PB, ROOT, TINY_CELLS, run_cell

SEED = 2_718_281_828_459


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_a_run_is_correct(tiny_root, capsys, cell):
    r = run_cell(tiny_root, capsys, "--workload", cell, "--seed", str(SEED),
                 "--seconds", "0.2", "--trace", "0")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert list(r)[-1] == "compared"
    want = {"dist": {"dist_pairs_per_s"}}.get(
        cell.split(".")[1], {"tree_joins_per_s", "tree_s_p95"})
    assert set(r["metrics"]) == want | {"peak_device_gib", "setup_s"}
    assert all(v["value"] > 0 for k, v in r["metrics"].items()
               if k != "peak_device_gib")


@pytest.mark.parametrize("cell", ["tiny.tree", "tiny.dist", "tiny.tree-b"])
def test_a_traced_run_reports_its_layers(tiny_root, capsys, cell):
    r = run_cell(tiny_root, capsys, "--workload", cell, "--seed", str(SEED),
                 "--seconds", "0.2", "--trace", "1")
    assert r["correct"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    # the CPU has no device events: only the idle shares and the host's
    # quantization are found
    want = {"tiny.tree": {"tree.device_idle_pct"},
            "tiny.dist": {"dist.device_idle_pct"},
            "tiny.tree-b": {"tree.device_idle_pct", "tree.quantize_ms"}}
    assert set(r["metrics"]) == want[cell]


def test_new_files_are_found(tiny_root, capsys):
    """A configuration, a traffic mix, a cell and a per-layer metric,
    each added as a file, run with no edit to a file already there."""
    cfg = json.loads((tiny_root / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny2", n=48, subst_per_generation=5.0)
    (tiny_root / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    tr = json.loads((tiny_root / "traffic" / "tree.json").read_text())
    tr.update(pool=3)
    (tiny_root / "traffic" / "tree-small-pool.json").write_text(
        json.dumps(tr))
    (tiny_root / "workloads" / "tiny2.tree-small-pool.json").write_text(
        json.dumps({"config": "tiny2", "traffic": "tree-small-pool",
                    "chips": 1, "check": 2}))
    (tiny_root / "metrics" / "tree.calls_in_window.py").write_text(
        "def read(ctx):\n"
        "    n = sum(1 for c in ctx.calls if 'joins' in c)\n"
        "    return (n, 'calls') if n else None\n")
    # and their entries in BENCHMARK.json
    bj = tiny_root.parent / "BENCHMARK.json"
    b = json.loads(bj.read_text())
    b["workloads"].append({"name": "tiny2.tree-small-pool",
                           "config": "tiny2", "traffic": "tree-small-pool",
                           "chips": 1, "why": "a smaller pool"})
    b["per_layer"].append({"name": "tree.calls_in_window", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "CLI seam",
                           "moves": "tree_joins_per_s",
                           "workloads": ["tiny2.tree-small-pool"]})
    bj.write_text(json.dumps(b))
    r = run_cell(tiny_root, capsys, "--workload", "tiny2.tree-small-pool",
                 "--seed", str(SEED), "--seconds", "0.1", "--trace", "1")
    assert r["correct"] and r["info"]["trees_compared"] >= 2
    assert r["metrics"]["tree.calls_in_window"]["value"] == r["attempted"]


def _broken(monkeypatch, fault):
    """Break the seam's call underneath the harness."""
    real = registry.seam

    def seam(name):
        Base = real(name)

        class Broken(Base):
            last = None

            def call(self, k):
                out, rec = Base.call(self, k)
                if fault == "altered":
                    if isinstance(out, bytes):
                        out = out.replace(b"iso", b"isO", 1)
                    else:
                        out = out.copy()
                        out[1, 0] += 1
                elif fault == "unchanged":
                    # the state the previous call left
                    out, Broken.last = (Broken.last if Broken.last
                                        is not None else out), out
                elif fault == "half":
                    if isinstance(out, bytes):
                        h = self.n // 2
                        flat = self.pool[k][:h * (h - 1) // 2]
                        out = Base.control  # a placeholder never returned
                        from port_bench.reference import dnj
                        out = dnj.newick(flat, h, [dnj.RefName(d, c) for
                                                   d, c in self.names[:h]],
                                         self.traffic["dtype"],
                                         self.traffic["bytescale"])
                    else:
                        out = out.copy()
                        out[self.n // 2:] = 0
                return out, rec
        return Broken
    monkeypatch.setattr(registry, "seam", seam)


@pytest.mark.parametrize("fault", ["altered", "unchanged", "half"])
@pytest.mark.parametrize("cell", ["tiny.tree", "tiny.dist", "tiny.tree-b"])
def test_a_broken_path_is_not_correct(tiny_root, capsys, monkeypatch,
                                      fault, cell):
    _broken(monkeypatch, fault)
    r = run_cell(tiny_root, capsys, "--workload", cell, "--seed", str(SEED),
                 "--seconds", "0.1", "--trace", "0")
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("cell", ["tiny.tree", "tiny.dist", "tiny.tree-b"])
def test_the_control_is_not_correct(tiny_root, capsys, cell):
    """The reference one precision lower in the program's place: float32
    state, 4-bit cells, bfloat16 products."""
    r = run_cell(tiny_root, capsys, "--workload", cell, "--seed", str(SEED),
                 "--seconds", "0", "--trace", "0", "--control", "1")
    assert not r["correct"]
    wrong = r["compared"].get("trees_wrong", r["compared"].get(
        "cells_wrong"))["value"]
    assert wrong > 0


@pytest.mark.parametrize("cell", ["tiny.tree", "tiny.tree-b"])
def test_a_call_off_its_route_is_not_correct(tiny_root, capsys, monkeypatch,
                                             cell):
    """A tree handed to the host engine, though its bytes are right,
    fails the run and leaves the card's joins."""
    real = registry.seam

    def seam(name):
        Base = real(name)

        class OffRoute(Base):
            def call(self, k):
                out, rec = Base.call(self, k)
                if k == 1:
                    rec.update(engine="exact", card_joins=0)
                return out, rec
        return OffRoute
    monkeypatch.setattr(registry, "seam", seam)
    r = run_cell(tiny_root, capsys, "--workload", cell, "--seed", str(SEED),
                 "--seconds", "0.1", "--trace", "0")
    assert not r["correct"] and r["failed"] > 0
    assert r["compared"]["off_route_calls"]["value"] > 0
    assert r["compared"]["trees_wrong"]["value"] == 0


def test_the_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 100, "dur": 100, "pid": 1, "tid": 7},
          {"ph": "X", "cat": "user_annotation", "name": trace.CALL,
           "ts": 101, "dur": 98, "pid": 1, "tid": 7},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
           "ts": 150, "dur": 25, "pid": 1, "tid": 7},
          {"ph": "X", "cat": "cpu_op", "name": "other thread",
           "ts": 150, "dur": 25, "pid": 1, "tid": 8},
          {"ph": "X", "cat": "kernel", "name": "void k<1>(int*)",
           "ts": 110, "dur": 20, "pid": 0, "tid": 3},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 120, "dur": 20, "pid": 0, "tid": 4},
          {"ph": "X", "cat": "kernel", "name": "late",
           "ts": 300, "dur": 5, "pid": 0, "tid": 3}]
    r = trace.reduce(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(30e-6)   # 110-140, overlap merged
    assert [d[0] for d in r["device"]] == ["void k<1>(int*)", "Memcpy HtoD"]
    assert r["breakdown"]["device_ops"][0] == ["k<1>", pytest.approx(20e-6)]
    gaps = dict(r["breakdown"]["idle_gaps"])
    # 100-110 and 140-200: the gap 140-200 centres on aten::copy_
    assert gaps == {trace.CALL: pytest.approx(10e-6),
                    "aten::copy_": pytest.approx(60e-6)}


def test_forbidden_modules_by_whole_name(monkeypatch):
    from port_bench import harness
    for name in ("jax", "jax.numpy", "jaxlib", "flax", "ccphylo_tpu",
                 "ccphylo_tpu.ops", "benchmarks.synth"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_loaded() == ["benchmarks", "ccphylo_tpu",
                                          "flax", "jax", "jaxlib"]
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "ccphylo_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_loaded() == []


def test_a_run_imports_no_jax_package(tiny_root):
    """A whole CPU run in a fresh process, then its modules."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from port_bench.harness import main, FORBIDDEN\n"
        f"rc = main(['--workload', 'tiny.tree', '--seed', '5', '--seconds',"
        f" '0.1', '--trace', '0'], time.perf_counter(), root={str(tiny_root)!r},"
        " dev=torch.device('cpu'))\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))\n"
        "assert rc == 0 and not bad, (rc, bad)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "CCPHYLO_TORCH_DEVICE": "cpu"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


def _imports(path):
    import ast
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_references_no_program():
    from port_bench.harness import FORBIDDEN
    for dirpath, _, files in os.walk(PB):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & set(FORBIDDEN), (path, tops)
            plain = os.path.relpath(dirpath, PB).split(os.sep)[0] in (
                "reference", "gen", "roofline")
            assert not (plain and "ccphylo_tpu_torch" in tops), path


def test_run_exits_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would proceed")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "mrsa2282.tree", "--seed", "3000000000",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_json_names_the_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    for c in b["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
    for w in b["workloads"]:
        wl, cfg, tr = registry.cell(w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"]) == (
            w["config"], w["traffic"], w["chips"])
    names = set(registry.readers())
    assert {m["name"] for m in b["per_layer"]} <= names


def test_a_cell_reports_what_benchmark_json_declares(tmp_path):
    """A declared cell keeps only its declared metrics; an undeclared
    one keeps all."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    root = str(tmp_path / "port_bench")
    keep = registry.declared("mrsa2282.tree", root)
    assert {"tree_joins_per_s", "tree_s_p95"} <= keep
    assert "tree.quantize_ms" not in keep
    assert "tree.quantize_ms" in registry.declared("mrsa2282.tree-b", root)
    assert "dist.copy_ms" not in keep and "dist.device_idle_pct" not in keep
    assert registry.declared("tiny.tree", root) is None
