"""Roofline counts against hand counts at tiny shapes, and the readers
that turn them into shares."""

from types import SimpleNamespace

import pytest

from port_bench import registry
from port_bench.roofline.dist_bytes import fill_bytes
from port_bench.roofline.tree_bytes import tree_bytes


def test_dist_bytes_by_hand():
    # 4 samples of 64 positions: 2 u64 words each, 2 include words, 4x4 int32
    assert fill_bytes(4, 64) == 4 * 2 * 8 + 2 * 4 + 16 * 4
    # a partial last word counts whole
    assert fill_bytes(2, 65) == 2 * 3 * 8 + 3 * 4 + 4 * 4


@pytest.mark.parametrize("n,cell,want", [
    (3, 8, 3 * 3 * 8 + 24),
    (5, 1, 3 * (3 + 4 + 5) + 24 * 3),
    (2, 8, 0)])
def test_tree_bytes_by_hand(n, cell, want):
    assert tree_bytes(n, cell) == want


def _ctx(calls, device, window_s=1.0, busy_s=0.25, traffic=None, **cfg):
    return SimpleNamespace(cfg=cfg, calls=calls, device=device,
                           traffic=traffic or {}, window_s=window_s,
                           busy_s=busy_s, peaks={"hbm_bytes_per_s": 3.35e12})


def test_tree_readers():
    """The kernel readers count the joins of the trees the card built;
    a call handed to the host engine is left out of them."""
    r = registry.readers()
    card = {"joins": 3, "engine": "float64", "card_joins": 3}
    host = {"joins": 3, "engine": "exact", "card_joins": 0}
    dev = [("void dnj_segment_float_kernel<double>(double*)", "kernel",
            0.0, 10.0),
           ("Memcpy HtoD", "gpu_memcpy", 20.0, 2.0)]
    ctx = _ctx([card, host, card], dev, n=5, traffic={"cell_bytes": 8})
    assert r["tree.segment_us_per_join"](ctx) == (10.0 / 6, "us/join")
    share, unit = r["tree.dnj_segment_roofline"](ctx)
    assert unit == "%" and share == pytest.approx(
        100 * 2 * tree_bytes(5, 8) / 3.35e12 / 10e-6)
    assert r["tree.launches_per_join"](ctx) == (2 / 6, "launches/join")
    assert r["tree.device_idle_pct"](ctx) == (75.0, "%")
    assert r["tree.quantize_ms"](ctx) is None
    ctx.calls = [host]
    assert r["tree.segment_us_per_join"](ctx) is None
    assert r["tree.dnj_segment_roofline"](ctx) is None
    assert r["tree.launches_per_join"](ctx) is None
    ctx.calls = [{"joins": 3, "engine": "packed", "card_joins": 3,
                  "quantize_s": 0.002}]
    ctx.traffic = {"cell_bytes": 1}
    assert r["tree.quantize_ms"](ctx) == (2.0, "ms/tree")
    share, _ = r["tree.dnj_segment_roofline"](ctx)
    assert share == pytest.approx(100 * tree_bytes(5, 1) / 3.35e12 / 10e-6)


def test_dist_readers():
    r = registry.readers()
    dev = [("expand_shared_kernel(unsigned int const*)", "kernel", 0.0, 40.0),
           ("Memcpy DtoH", "gpu_memcpy", 50.0, 30.0)]
    ctx = _ctx([{"pairs": 6}, {"pairs": 6}], dev, n=4, genome_bp=64)
    share, _ = r["dist.snp_matrix_roofline"](ctx)
    assert share == pytest.approx(100 * 2 * fill_bytes(4, 64) / 3.35e12
                                  / 40e-6)
    assert r["dist.copy_ms"](ctx) == (0.015, "ms/fill")
    assert r["dist.device_idle_pct"](ctx) == (75.0, "%")
    assert r["tree.segment_us_per_join"](ctx) is None
    assert r["tree.dnj_segment_roofline"](ctx) is None


def test_readers_find_nothing_in_an_empty_window():
    ctx = _ctx([], [], window_s=0.0, busy_s=0.0, n=4, genome_bp=64,
               traffic={"cell_bytes": 8})
    assert all(read(ctx) is None for read in registry.readers().values())
