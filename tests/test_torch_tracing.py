"""The port's spans and counters (ccphylo_tpu_torch/utils/timing.py) on
the CPU: the spans the tree and dist seams open under a torch.profiler,
on the caller's thread and nested as the engines nest their steps; no
record_function and no count while tracing is off; the packed engine's
`last_times` read from its spans; the scan-pass counter against the
engines' own count; the dist seams' u64 words uploaded unconverted
with no host stack, their counts against the host route's, their fill
counters and spans once a fill; self time on a fake clock."""

import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import ccphylo_tpu_torch.tree.packed_engine as tpe
import ccphylo_tpu_torch.tree.torch_engine as te
from ccphylo_tpu_torch.cli import dist_cmd, tree_cmd
from ccphylo_tpu_torch.io.qseqs import Name
from ccphylo_tpu_torch.utils import timing

torch.set_num_threads(1)

OUTER = "test/outer"
N = 40

FLOAT_SPANS = {"tree/square": None, "tree/upload": None,
               "tree/engine": None, "tree/init": "tree/engine",
               "tree/segment": "tree/engine", "tree/records": "tree/engine",
               "tree/newick": None}
PACKED_SPANS = {"tree/quantize": None, "tree/engine": None,
                "tree/init": "tree/engine", "tree/segment": "tree/engine",
                "tree/limbs": None, "tree/newick": None}
DIST_SPANS = {"dist/stack": None, "dist/convert": None, "dist/upload": None,
              "dist/kernels": None, "dist/copy_back": None}


@pytest.fixture
def fresh(monkeypatch):
    """Tracing off unless a profiler records, totals empty, the CPU."""
    monkeypatch.setattr(timing, "_MODE", "")
    monkeypatch.setattr(timing, "_spans", {})
    monkeypatch.setattr(timing, "_counters", {})
    monkeypatch.setenv("CCPHYLO_TORCH_DEVICE", "cpu")


def _names(n):
    return [Name(b"t%03d" % i, 48) for i in range(n)]


def _flat(n, seed=5):
    rng = np.random.RandomState(seed)
    return rng.randint(1, 60, n * (n - 1) // 2).astype(np.float64)


def _shared_inputs(n=6, words=8, seed=3):
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(0, 2 ** 63, words, dtype=np.int64).astype(np.uint64)
            for _ in range(n)]
    inc = rng.randint(0, 2 ** 32, words, dtype=np.int64).astype(np.uint32)
    return seqs, list(range(n)), inc


def _pairwise_inputs(n=6, words=8, seed=4):
    seqs, idxs, _ = _shared_inputs(n, words, seed)
    rng = np.random.RandomState(seed + 1)
    incs = [rng.randint(0, 2 ** 32, words, dtype=np.int64).astype(np.uint32)
            for _ in range(n)]
    return seqs, incs, idxs


def _float():
    return te.build_tree_float(_flat(N), N, _names(N), dtype=torch.float64,
                               device="cpu")


def _packed():
    return tpe.build_tree_packed(_flat(N), N, _names(N), device="cpu")


def _dist():
    return dist_cmd._batch_shared(*_shared_inputs())


def _traced(fn, tmp_path):
    """fn() under a CPU profiler inside a span OUTER; (result, the
    trace's complete events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(OUTER):
            out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X"]


def _inside(a, b) -> bool:
    return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]


@pytest.mark.parametrize("fn, want", [(_float, FLOAT_SPANS),
                                      (_packed, PACKED_SPANS),
                                      (_dist, DIST_SPANS)],
                         ids=["build_tree_float", "build_tree_packed",
                              "_batch_shared"])
def test_spans_nest_on_the_callers_thread(fresh, tmp_path, fn, want):
    _, xs = _traced(fn, tmp_path)
    outer = next(e for e in xs if e["name"] == OUTER)
    ours = [e for e in xs if e.get("cat") == "user_annotation"
            and "/" in e["name"] and e["name"] != OUTER]
    assert {e["name"] for e in ours} == set(want)
    for e in ours:
        assert (e["pid"], e["tid"]) == (outer["pid"], outer["tid"])
        assert _inside(e, outer)
        parent = want[e["name"]]
        if parent is not None:
            assert any(p["name"] == parent and _inside(e, p) for p in ours)
    # the top-level steps follow one another, each opened once
    top = sorted((e for e in ours if want[e["name"]] is None),
                 key=lambda e: e["ts"])
    assert [e["name"] for e in top] == [k for k, v in want.items()
                                        if v is None]
    for a, b in zip(top, top[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    # one segment span per 1024 joins
    assert sum(e["name"] == "tree/segment" for e in ours) \
        == (1 if fn is not _dist else 0)


def test_dispatch_build_spans_its_route(fresh, tmp_path):
    flat = _flat(N)
    _, xs = _traced(lambda: tree_cmd._dispatch_build(
        flat, N, _names(N), "dnj", 0, 9, "d", 1.0), tmp_path)
    assert tree_cmd._dispatch_build.last_engine == "float64"
    names = [e["name"] for e in sorted(xs, key=lambda e: e["ts"])
             if e.get("cat") == "user_annotation" and e["name"] != OUTER]
    assert names[:2] == ["tree/route", "tree/square"]


@pytest.mark.parametrize("fn", [_float, _packed, _dist],
                         ids=["build_tree_float", "build_tree_packed",
                              "_batch_shared"])
def test_no_record_function_while_tracing_is_off(fresh, monkeypatch, fn):
    def refuse(*a, **k):
        raise AssertionError("record_function opened while tracing is off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not timing.enabled()
    fn()
    assert timing.spans() == {} and timing.counters() == {}


def test_last_times_are_the_spans_seconds(fresh):
    _packed()
    assert set(tpe.build_tree_packed.last_times) == {
        "quantize", "engine", "limbs", "newick"}
    assert timing.spans() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        _packed()
    got = timing.spans()
    for k, secs in tpe.build_tree_packed.last_times.items():
        assert secs > 0 and got["tree/" + k][:2] == (secs, 1)


def test_scan_passes_counted_only_while_tracing(fresh, monkeypatch):
    states = []
    real = te._new_state

    def keep(D, m):
        states.append(real(D, m))
        return states[-1]
    monkeypatch.setattr(te, "_new_state", keep)
    _float()
    _packed()
    assert "tree/scan_passes" not in timing.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _float()
    float_passes = int(states[-1]["stats"][0])
    assert float_passes > 0
    assert timing.counters()["tree/scan_passes"] == float_passes
    with profile(activities=[ProfilerActivity.CPU]):
        _packed()
    packed_passes = int(tpe.dnj_joins_packed.last_stats[0])
    assert packed_passes > 0
    assert timing.counters()["tree/scan_passes"] \
        == float_passes + packed_passes


def test_self_time_leaves_out_the_spans_inside(fresh, monkeypatch):
    """On a fake clock: outer 0-10 s holding a 2-4 s and a 5-8 s span."""
    ticks = iter([0.0, 2.0, 4.0, 5.0, 8.0, 10.0])
    monkeypatch.setattr(timing, "time",
                        SimpleNamespace(perf_counter=lambda: next(ticks)))
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.phase("a/outer"):
            with timing.phase("a/inner"):
                pass
            with timing.phase("a/inner", items=7):
                pass
    assert timing.spans() == {"a/outer": (10.0, 1, 5.0),
                              "a/inner": (5.0, 2, 5.0)}
    assert timing.counters() == {"a/inner/items": 7}


def test_spans_of_other_threads_keep_their_own_stack(fresh, monkeypatch):
    """Under CCPHYLO_TORCH_PROFILE every thread traces; a span on another
    thread is no child of one open on this one."""
    monkeypatch.setattr(timing, "_MODE", "stderr")
    monkeypatch.setattr(timing, "_registered", True)

    def side():
        with timing.phase("a/side"):
            pass

    with timing.phase("a/outer"):
        t = threading.Thread(target=side)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    got = timing.spans()
    assert got["a/outer"][0] == got["a/outer"][2]
    assert got["a/side"][1] == 1


def test_into_times_without_tracing(fresh):
    times = {}
    with timing.phase("tree/quantize", into=times):
        pass
    assert list(times) == ["quantize"] and times["quantize"] >= 0
    assert timing.spans() == {}


def _skip(args, k):
    """args with its k-th, the fill's sample indices, leaving out every
    37th sample (from the 6th): a fill of fewer rows than the loader's
    arrays."""
    args = list(args)
    args[k] = [i for i in args[k] if i % 37 != 5]
    return tuple(args)


# seam -> (dist_cmd function, its inputs); 133 and 530 fills need
# padded rows (to 256, 1024: neither a multiple of 128 nor of 512)
DIST_SEAMS = {"_batch_shared": ("_batch_shared", _shared_inputs),
              "_batch_pairwise": ("_batch_pairwise", _pairwise_inputs),
              "_batch_shared-133": (
                  "_batch_shared", lambda: _skip(_shared_inputs(137), 1)),
              "_batch_pairwise-133": (
                  "_batch_pairwise", lambda: _skip(_pairwise_inputs(137), 2)),
              "_batch_shared-530": (
                  "_batch_shared", lambda: _skip(_shared_inputs(545), 1)),
              "_batch_pairwise-530": (
                  "_batch_pairwise", lambda: _skip(_pairwise_inputs(545), 2))}


class _NoStack:
    """numpy for dist_cmd, with `stack` refused."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def stack(*a, **k):
        raise AssertionError("np.stack called on the device route")


@pytest.mark.parametrize("seam", list(DIST_SEAMS))
def test_dist_seams_upload_u64_words_unconverted(fresh, monkeypatch, seam):
    """The device route (the plain versions on the CPU) stacks no
    samples on the host (dist_cmd's `np.stack` raises here), never
    converts the sample words to u32 (`u64_to_u32` raises), nor, in
    `_batch_pairwise`, the samples' include words to pair masks
    (`inc32_to_pairmask` raises), and gives the counts of the
    CCPHYLO_TORCH_DIST=host route, also where the fill leaves samples
    out and its rows need padding; each of its fills counts one
    `dist/u64_fills` and one `dist/direct_fills` (and, per-sample
    masks, one `dist/inc_word_fills`) and opens each dist/* span once
    while tracing is on, none while off.  The CPU has no upload ring,
    so no `dist/ring_blocks`."""
    from ccphylo_tpu_torch.ops import snp_torch

    name, inputs = DIST_SEAMS[seam]
    pairwise = name == "_batch_pairwise"
    refused = ["u64_to_u32"]
    if pairwise:
        refused.append("inc32_to_pairmask")
    for fname in refused:
        def refuse(*a, _name=fname, **k):
            raise AssertionError(f"{_name} called on the device route")
        monkeypatch.setattr(snp_torch, fname, refuse)
        monkeypatch.setattr(dist_cmd, fname, refuse, raising=False)
    fn = getattr(dist_cmd, name)
    args = inputs()
    n = len(args[-1] if pairwise else args[1])
    with monkeypatch.context() as m:
        m.setattr(dist_cmd, "np", _NoStack())
        ours = fn(*args)
    monkeypatch.setenv("CCPHYLO_TORCH_DIST", "host")
    host = fn(*args)
    monkeypatch.delenv("CCPHYLO_TORCH_DIST")
    if not pairwise:
        assert ours.shape == (n, n)
        np.testing.assert_array_equal(ours, host)
    else:
        assert ours[0].shape == ours[1].shape == (n, n)
        np.testing.assert_array_equal(ours[0], host[0])
        # the host kernel leaves the (unused) diagonal of `shared` at 0
        off = ~np.eye(n, dtype=bool)
        np.testing.assert_array_equal(ours[1][off], host[1][off])
    assert timing.counters() == {}
    with monkeypatch.context() as m:
        m.setattr(dist_cmd, "np", _NoStack())
        with profile(activities=[ProfilerActivity.CPU]):
            fn(*args)
            fn(*args)
    assert timing.counters() == {"dist/u64_fills": 2,
                                 "dist/direct_fills": 2,
                                 **({"dist/inc_word_fills": 2}
                                    if pairwise else {})}
    spans = timing.spans()
    assert {k: v[1] for k, v in spans.items() if k.startswith("dist/")} \
        == {k: 2 for k in DIST_SPANS}
