"""The readers of the program's spans and counters (port_bench/program.py
and the metrics that use it): nothing without their span or counter,
nothing from a program that keeps no totals, the numbers on totals
given, and a traced tiny run of each cell reporting the ones its
entries name and no other."""

from types import SimpleNamespace

import pytest

from port_bench import registry
from port_bench.tests.conftest import TINY_CELLS, run_cell

from ccphylo_tpu_torch.utils import timing

SEED = 3_141_592_653_589
NEW = {"tree.square_ms": ("tiny.tree",),
       "tree.newick_ms": ("tiny.tree", "tiny.tree-b"),
       "tree.scan_passes_per_join": ("tiny.tree", "tiny.tree-b"),
       "dist.prep_ms": ("tiny.dist",)}


@pytest.fixture
def totals(monkeypatch):
    """The program's totals, empty, for the test to fill."""
    spans, counters = {}, {}
    monkeypatch.setattr(timing, "_spans", spans)
    monkeypatch.setattr(timing, "_counters", counters)
    return spans, counters


def _ctx(joins=(100, 100)):
    return SimpleNamespace(calls=[{"card_joins": j, "s": 0.1}
                                  for j in joins])


@pytest.mark.parametrize("metric", sorted(NEW))
def test_nothing_without_the_span(totals, metric):
    spans, counters = totals
    spans["tree/route"] = [0.5, 5, 0.5]
    counters["tree/route/items"] = 5
    assert registry.readers()[metric](_ctx()) is None


@pytest.mark.parametrize("metric", sorted(NEW))
def test_nothing_from_a_program_without_totals(totals, monkeypatch, metric):
    spans, counters = totals
    spans.update({k: [0.5, 5, 0.5] for k in (
        "tree/square", "tree/newick", "dist/stack", "dist/convert")})
    counters["tree/scan_passes"] = 300.0
    monkeypatch.delattr(timing, "spans")
    monkeypatch.delattr(timing, "counters")
    assert registry.readers()[metric](_ctx()) is None


def test_the_numbers(totals):
    spans, counters = totals
    spans.update({"tree/square": [0.2, 4, 0.2], "tree/newick": [0.1, 4, 0.1],
                  "dist/stack": [3.0, 2, 3.0], "dist/convert": [1.0, 2, 1.0]})
    counters["tree/scan_passes"] = 300.0
    read = registry.readers()
    ctx = _ctx((100, 0, 200))
    assert read["tree.square_ms"](ctx) == pytest.approx((50.0, "ms/tree"))
    assert read["tree.newick_ms"](ctx) == pytest.approx((25.0, "ms/tree"))
    assert read["tree.scan_passes_per_join"](ctx) == (1.0, "passes/join")
    assert read["dist.prep_ms"](ctx) == pytest.approx((2000.0, "ms/fill"))
    assert read["tree.scan_passes_per_join"](_ctx((0,))) is None


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_a_traced_run_reports_the_programs_numbers(tiny_root, capsys, totals,
                                                   cell):
    r = run_cell(tiny_root, capsys, "--workload", cell, "--seed", str(SEED),
                 "--seconds", "0.2", "--trace", "1")
    assert r["correct"]
    got = {k for k in r["metrics"] if k in NEW}
    assert got == {k for k, cells in NEW.items() if cell in cells}
    assert all(r["metrics"][k]["value"] > 0 for k in got)
    # every call opened each step once, in the window alone
    spans, _ = totals
    steps = {"tiny.dist": "dist/stack"}.get(cell, "tree/newick")
    assert spans[steps][1] == r["attempted"]
