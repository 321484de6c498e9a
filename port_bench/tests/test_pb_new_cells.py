"""The cells added with dnj-100k at tiny sizes on the CPU: the u8 tree
cell (`seams/tree_u8.py`, `gen/clone_u8.py`, `reference/dnj_u8.py`) and
the per-sample-mask dist cell (`seams/dist_pairwise.py`,
`reference/snp_pairwise.py`): whole runs, traced and untraced, faults
under the seam and the controls coming out not correct, a program
without the u8 entry refused before the pool is made, the generator
against a plain walk of its tree, the references against the program's
CPU path and `reference/dnj.py`, the byte count and the readers."""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import harness, registry
from port_bench.gen import clone_u8, collection, hash_u8
from port_bench.reference import dnj, dnj_u8, snp_pairwise
from port_bench.roofline.dist_pairwise_bytes import fill_bytes
from port_bench.seams import dist_pairwise
from port_bench.conftest import MORE_CELLS, MORE_TINY, tiny_benchmark, \
    tiny_config
from port_bench.tests.conftest import PB, run_cell

from ccphylo_tpu_torch.utils import timing

torch.set_num_threads(1)

SEED = 5_772_156_649_015
TREE, DIST = "tiny100k.tree-b", "tiny.dist-pairwise"


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A copy of the benchmark's data folders with the tiny stand-ins of
    these cells added, every cell declared in a BENCHMARK.json beside it,
    and the program on the CPU."""
    root = tmp_path / "port_bench"
    for d in ("metrics", "roofline", "traffic", "configs", "workloads"):
        shutil.copytree(os.path.join(PB, d), root / d)
    for name in ("tiny", *MORE_TINY):
        (root / "configs" / f"{name}.json").write_text(
            json.dumps(tiny_config(name)))
    for cell, (cfg, traffic, check) in MORE_CELLS.items():
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": cfg, "traffic": traffic, "chips": 1,
             "check": check}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(tiny_benchmark()))
    monkeypatch.setenv("CCPHYLO_TORCH_DEVICE", "cpu")
    return root


@pytest.fixture
def totals(monkeypatch):
    """The program's totals, empty: a traced run's are its own."""
    monkeypatch.setattr(timing, "_spans", {})
    monkeypatch.setattr(timing, "_counters", {})


@pytest.mark.parametrize("cell", sorted(MORE_CELLS))
def test_a_run_is_correct(tiny_root, capsys, cell):
    r = run_cell(tiny_root, capsys, "--workload", cell, "--seed", str(SEED),
                 "--seconds", "0.2", "--trace", "0")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    want = {"dist_pairs_per_s"} if cell == DIST else {"tree_joins_per_s",
                                                       "tree_s_p95"}
    assert set(r["metrics"]) == want | {"peak_device_gib", "setup_s"}
    if cell == TREE:
        assert r["info"]["engines"] == {"packed": r["attempted"]}


@pytest.mark.parametrize("cell", sorted(MORE_CELLS))
def test_a_traced_run_reports_its_layers(tiny_root, capsys, totals, cell):
    """The CPU has no device events: the idle share and the program's
    own spans and counters are found, and no other metric."""
    r = run_cell(tiny_root, capsys, "--workload", cell, "--seed", str(SEED),
                 "--seconds", "0.2", "--trace", "1")
    assert r["correct"]
    want = {TREE: {"tree.device_idle_pct", "tree.pack_ms",
                   "tree.host_bytes_per_cell", "tree.newick_ms",
                   "tree.scan_passes_per_join"},
            DIST: {"dist.device_idle_pct", "dist.prep_ms"}}[cell]
    assert set(r["metrics"]) == want
    if cell == TREE:
        assert r["metrics"]["tree.host_bytes_per_cell"]["value"] == 1.0
        assert r["metrics"]["tree.pack_ms"]["value"] > 0


def _broken(monkeypatch, fault):
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
                        out = (out[0].copy(), out[1])
                        out[0][1, 0] += 1
                elif fault == "unchanged":
                    out, Broken.last = (Broken.last if Broken.last
                                        is not None else out), out
                elif fault == "half":
                    h = self.n // 2
                    if isinstance(out, bytes):
                        out = dnj_u8.newick(
                            self.pool[k][:h * (h - 1) // 2], h,
                            [dnj.RefName(d, c) for d, c in self.names[:h]])
                    else:
                        out = tuple(o.copy() for o in out)
                        out[1][h:] = 0
                return out, rec
        return Broken
    monkeypatch.setattr(registry, "seam", seam)


@pytest.mark.parametrize("fault", ["altered", "unchanged", "half"])
@pytest.mark.parametrize("cell", sorted(MORE_CELLS))
def test_a_broken_path_is_not_correct(tiny_root, capsys, monkeypatch,
                                      fault, cell):
    _broken(monkeypatch, fault)
    r = run_cell(tiny_root, capsys, "--workload", cell, "--seed", str(SEED),
                 "--seconds", "0.1", "--trace", "0")
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("cell", sorted(MORE_CELLS))
def test_the_control_is_not_correct(tiny_root, capsys, cell):
    """4-bit cells; bfloat16 products."""
    r = run_cell(tiny_root, capsys, "--workload", cell, "--seed", str(SEED),
                 "--seconds", "0", "--trace", "0", "--control", "1")
    assert not r["correct"]
    key = "cells_wrong" if cell == DIST else "trees_wrong"
    assert r["compared"][key]["value"] > 0


def test_a_call_off_its_route_is_not_correct(tiny_root, capsys,
                                             monkeypatch):
    real = registry.seam

    def seam(name):
        Base = real(name)

        class OffRoute(Base):
            def call(self, k):
                out, rec = Base.call(self, k)
                rec.update(engine="exact", card_joins=0)
                return out, rec
        return OffRoute
    monkeypatch.setattr(registry, "seam", seam)
    r = run_cell(tiny_root, capsys, "--workload", TREE, "--seed", str(SEED),
                 "--seconds", "0.1", "--trace", "0")
    assert not r["correct"] and r["compared"]["off_route_calls"]["value"]


def test_a_program_without_the_u8_entry_exits_first(tiny_root, monkeypatch):
    """The parent's packed route would widen the cells to float64 on the
    host: the seam exits before it makes the pool."""
    from ccphylo_tpu_torch.tree import packed_engine
    made = []
    monkeypatch.delattr(packed_engine, "pack_cells")
    monkeypatch.setattr(clone_u8, "cells", lambda *a: made.append(a))
    with pytest.raises(SystemExit) as e:
        harness.main(["--workload", TREE, "--seed", str(SEED), "--seconds",
                      "0", "--trace", "0"], 0.0, root=str(tiny_root),
                     dev=torch.device("cpu"))
    assert "pack_cells" in str(e.value.code) and not made


@pytest.mark.parametrize("seed", [7, 2 ** 33 + 5])
def test_clone_cells_are_path_lengths(seed):
    """At n = 300, each cell is the length of the path between its two
    isolates in the transmission tree, found by walking up from both."""
    cfg = dict(tiny_config("tiny100k"), n=300)
    parent, w = clone_u8.events(cfg, seed, 0, "cpu")
    got = clone_u8.cells(cfg, seed, 0, "cpu")

    def walk(i, j):
        up, a, s = {}, i, 0
        while a >= 0:
            up[a] = s
            s += w[a]
            a = parent[a]
        s = 0
        while j not in up:
            s += w[j]
            j = parent[j]
        return s + up[j]

    want = [walk(i, j) for i in range(300) for j in range(i)]
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert parent[0] == -1 and all(p < i for i, p in enumerate(parent))
    assert np.array_equal(got, clone_u8.cells(cfg, seed, 0, "cpu"))
    assert not np.array_equal(got, clone_u8.cells(cfg, seed, 1, "cpu"))


def test_clone_cells_beyond_the_largest_cell_fail():
    cfg = dict(tiny_config("tiny100k"), n=200, max_cell=20)
    with pytest.raises(ValueError, match="exceeds the largest cell"):
        clone_u8.cells(cfg, SEED, 0, "cpu")


def _names(n):
    return [dnj.RefName(d, c) for d, c in collection.name_specs(n)]


@pytest.mark.parametrize("cols", [16, 8192])
@pytest.mark.parametrize("bs", [1.0, 2.0])
@pytest.mark.parametrize("seed", [1, 2])
def test_dnj_u8_equals_dnj(monkeypatch, seed, bs, cols):
    """On -b matrices (tie-heavy and not), at dyadic ByteScales, with
    the 8-bit and the control's 4-bit cells, first batches of 1, 3 and
    64 revalidated rows, and steps over all columns or over widths
    rounded up to 16."""
    monkeypatch.setattr(dnj_u8, "_STEP_COLS", cols)
    rng = np.random.default_rng(seed)
    for n in (3, 4, 9, 40, 130):
        for top in (4, 200):
            flat = rng.integers(0, top, n * (n - 1) // 2).astype(np.float64)
            q = np.clip(np.floor(flat * bs + 0.5), 0, 255).astype(np.uint8)
            for qmax in (255, 15):
                want = dnj.newick(flat, n, _names(n), "b", bs, qmax=qmax)
                for batch in (1, 3, 64):
                    assert dnj_u8.newick(q, n, _names(n), bs, "cpu",
                                         qmax=qmax, batch=batch) == want


def test_dnj_u8_equals_the_programs_cpu_path(monkeypatch):
    from ccphylo_tpu_torch.cli import tree_cmd
    from ccphylo_tpu_torch.io.qseqs import Name
    monkeypatch.setenv("CCPHYLO_TORCH_DEVICE", "cpu")
    cfg = dict(tiny_config("tiny100k"), n=150)
    cells = clone_u8.cells(cfg, SEED, 0, "cpu")
    specs = collection.name_specs(150)
    got = tree_cmd._dispatch_build(cells, 150, [Name(d, c) for d, c in specs],
                                   "dnj", 0, 9, "b", 1.0)
    assert tree_cmd._dispatch_build.last_engine == "packed"
    assert dnj_u8.newick(cells, 150, _names(150)) == got
    assert dnj_u8.newick(cells, 150, _names(150), qmax=15) != got


def test_sample_masks_are_the_shared_mask_less_runs():
    cfg = dict(tiny_config("tiny"), genome_bp=200_003)
    traffic = registry.cell("mrsa2282.dist-pairwise")[2]
    seqs, shared = collection.alignment(cfg, SEED, 0, "cpu")
    m = dist_pairwise.sample_masks(cfg, traffic, SEED, 0, shared, "cpu")
    assert m.shape == (cfg["n"], shared.shape[0]) and m.dtype == np.uint32
    assert np.array_equal(m & shared, m)
    bits = np.unpackbits(m.astype(">u4").view(np.uint8), axis=1)
    own = 1 - bits.mean(1) / np.unpackbits(
        shared.astype(">u4").view(np.uint8)).mean()
    assert 0.005 < own.mean() < 0.015 and own.min() > 0
    assert np.array_equal(m, dist_pairwise.sample_masks(
        cfg, traffic, SEED, 0, shared, "cpu"))


def test_snp_pairwise_equals_the_programs_cpu_path(monkeypatch):
    from ccphylo_tpu_torch.cli import dist_cmd
    monkeypatch.setenv("CCPHYLO_TORCH_DEVICE", "cpu")
    cfg = tiny_config("tiny")
    traffic = registry.cell("mrsa2282.dist-pairwise")[2]
    seqs, shared = collection.alignment(cfg, SEED, 0, "cpu")
    incs = dist_pairwise.sample_masks(cfg, traffic, SEED, 0, shared, "cpu")
    n = cfg["n"]
    got = dist_cmd._batch_pairwise(list(seqs), list(incs), list(range(n)))
    want = snp_pairwise.counts(seqs, incs, "cpu", words=32)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert want[0].max() > 0
    assert (want[1] <= want[1].diagonal()[:, None]).all()
    low = snp_pairwise.counts(seqs, incs, "cpu", dtype=torch.bfloat16,
                              words=32)
    assert not np.array_equal(low[1], want[1])


def test_dist_pairwise_bytes_by_hand():
    # 4 samples of 64 positions: 2 u64 and 2 u32 words each, two 4x4 int32
    assert fill_bytes(4, 64) == 4 * 2 * 8 + 4 * 2 * 4 + 2 * 16 * 4


def _ctx(calls, device, **cfg):
    return SimpleNamespace(cfg=cfg, calls=calls, device=device, traffic={},
                           window_s=1.0, busy_s=0.5,
                           peaks={"hbm_bytes_per_s": 3.35e12})


def test_the_new_readers(totals):
    r = registry.readers()
    dev = [("expand_pairwise_kernel(int const*)", "kernel", 0.0, 40.0)]
    pw = {"pairs": 6, "masks": "per-sample"}
    share, unit = r["dist.snp_pairwise_roofline"](_ctx([pw, pw], dev, n=4,
                                                       genome_bp=64))
    assert unit == "%" and share == pytest.approx(
        100 * 2 * fill_bytes(4, 64) / 3.35e12 / 40e-6)
    assert r["dist.snp_pairwise_roofline"](
        _ctx([{"pairs": 6}], dev, n=4, genome_bp=64)) is None
    tree = [{"joins": 3, "card_joins": 3, "pack_s": 0.1}] * 2
    ctx = _ctx(tree, [], n=5)
    assert r["tree.pack_ms"](ctx) is None
    assert r["tree.host_bytes_per_cell"](ctx) is None
    timing._spans["tree/pack"] = [0.3, 2, 0.3]
    timing._counters["tree/host_cell_bytes"] = 20.0
    assert r["tree.pack_ms"](ctx) == pytest.approx((150.0, "ms/tree"))
    assert r["tree.host_bytes_per_cell"](ctx) == (1.0, "B/cell")
    assert r["tree.pack_ms"](_ctx([{"joins": 3}], [], n=5)) is None


def test_the_hash_matrix_is_the_smoke_scripts():
    """`gen/hash_u8.py` against the smoke script's numpy hash and its
    parity names, at n = 700."""
    import chip_smoke
    n = 700
    got = hash_u8.cells(n, "cpu")
    i, j = np.tril_indices(n, -1)
    assert np.array_equal(got, chip_smoke.hash_cells_np(i, j))
    want = [(x.data, x.cap) for x in chip_smoke.parity_names(n)]
    assert hash_u8.names(n) == want


@pytest.mark.parametrize("config", ["mrsa-2282", "dnj-100k"])
def test_every_reader_reads_every_configuration(config):
    """A traced run calls every reader of metrics/ on its cell, on the
    card with device events: none may fail on a configuration's keys,
    whatever the calls' records hold."""
    cfg = registry._json(registry.HERE, "configs", config)
    dev = [("dnj_segment_kernel(int*)", "kernel", 0.0, 40.0),
           ("Memcpy HtoD", "gpu_memcpy", 50.0, 30.0)]
    tree = [{"joins": 3, "engine": "packed", "card_joins": 3,
             "pack_s": 0.1, "quantize_s": 0.1, "s": 1.0}]
    dist = [{"pairs": 6, "masks": "per-sample", "s": 1.0}]
    for traffic, calls in (("tree", tree), ("tree-b-u8", tree),
                           ("dist", dist), ("dist-pairwise", dist)):
        tr = registry._json(registry.HERE, "traffic", traffic)
        ctx = SimpleNamespace(cfg=cfg, traffic=tr, calls=calls, device=dev,
                              window_s=1.0, busy_s=0.5,
                              peaks={"hbm_bytes_per_s": 3.35e12})
        for read in registry.readers().values():
            read(ctx)


@pytest.mark.parametrize("most", [4, 12])
def test_dnj_u8_with_capped_batches(monkeypatch, most):
    """Searches whose batches stop growing at `_MAX_ROWS` rows, so that
    a join walks many batches of the same size, equal `reference/dnj.py`
    too."""
    monkeypatch.setattr(dnj_u8, "_MAX_ROWS", most)
    monkeypatch.setattr(dnj_u8, "_STEP_COLS", 16)
    rng = np.random.default_rng(most)
    for n in (5, 70, 200):
        for top in (3, 90):
            flat = rng.integers(0, top, n * (n - 1) // 2).astype(np.float64)
            q = flat.astype(np.uint8)
            want = dnj.newick(flat, n, _names(n), "b", 1.0)
            for batch in (1, 2):
                assert dnj_u8.newick(q, n, _names(n), 1.0, "cpu",
                                     batch=batch) == want
