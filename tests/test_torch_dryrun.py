"""The port's compile check and dry run (ccphylo_tpu_torch/dryrun.py)
against the JAX package's (__graft_entry__.py: `entry`,
`dryrun_multichip`), on the CPU.

The port's dry runs of 1, 2 and 4 ranks (gloo) start once for the
module, side by side, with a run of the command line beside them; while
they work, the JAX dry run of each world runs here on a mesh of as many
virtual CPU devices, with every stage's JAX function wrapped to record
its inputs and outputs.  Every matrix is integer, so every comparison is
bit-exact (tolerance 0): the inputs (the port draws them in the JAX
module's order) and each stage's records.
"""

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
import ccphylo_tpu.ops.snp_jax as jsnp
import ccphylo_tpu.parallel.sharded_dnj as jsd
import ccphylo_tpu.parallel.sharded_nj as jsnj
import ccphylo_tpu.tree.hclust_engine as jhe
import ccphylo_tpu.tree.jax_engine as jje
import ccphylo_tpu.tree.packed_engine as jpe
import ccphylo_tpu.tree.streamed_engine as jse
from ccphylo_tpu_torch import dryrun

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORLDS = (1, 2, 4)
CLI_WORLD = 2
# the JAX functions of the stages: (module, name, leading inputs kept)
RECORDED = ((jsnp, "sharded_snp_matrix", 2), (jje, "dnj_joins", 1),
            (jsnj, "sharded_join_records", 1),
            (jsd, "sharded_dnj_records", 1), (jhe, "hclust_joins", 1),
            (jpe, "pack_words", 1), (jpe, "dnj_joins_packed", 0),
            (jse, "dnj_joins_streamed", 1))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "CCPHYLO_"))}
    env.update(PYTHONPATH=str(REPO), **extra)
    return env


def _record(calls, mod, name, keep):
    fn = getattr(mod, name)

    def recording(*args, **kw):
        # copies first: the JAX engines donate or update their matrix
        ins = [np.array(a) for a in args[:keep]]
        res = fn(*args, **kw)
        outs = [np.asarray(x) for x in res] if isinstance(res, tuple) \
            else np.asarray(res)
        calls.setdefault(name, []).append((ins, kw, outs))
        return res

    return recording


def jax_dryrun(world):
    """{JAX function name: [(inputs, keywords, outputs) per call]} of
    __graft_entry__.dryrun_multichip(world)."""
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, keep in RECORDED:
            mp.setattr(mod, name, _record(calls, mod, name, keep))
        graft.dryrun_multichip(world)
    return calls


@pytest.fixture(scope="module")
def runs():
    """({world: the port's dryrun_multichip result}, {world: the JAX
    dry run's calls}, the command line's CompletedProcess)."""
    with ThreadPoolExecutor(len(WORLDS) + 1) as pool:
        futs = {w: pool.submit(dryrun.dryrun_multichip, w, 240.0, "cpu")
                for w in WORLDS}
        cli = pool.submit(
            subprocess.run, [sys.executable, "-m", "ccphylo_tpu_torch.dryrun",
                             str(CLI_WORLD)],
            env=_env(CCPHYLO_TORCH_DEVICE="cpu"), capture_output=True,
            timeout=240)
        ref = {w: jax_dryrun(w) for w in WORLDS}
        return {w: f.result() for w, f in futs.items()}, ref, cli.result()


def _cut(x, T):
    x = np.asarray(x)
    return x[:T] if x.ndim else x


def _same(ours, theirs, T=None, what=""):
    for k, (a, b) in enumerate(zip(ours, theirs)):
        if T is not None:
            a, b = _cut(a, T), _cut(b, T)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} [{k}]")


def _port(res, prefix, keys):
    return [res[prefix + k] for k in keys]


def test_entry_matches_jax():
    fn, args = dryrun.entry("cpu")
    jfn, jargs = graft.entry()
    np.testing.assert_array_equal(args[0].numpy().view(np.uint32),
                                  np.asarray(jargs[0]))
    np.testing.assert_array_equal(args[1].numpy().view(np.uint32),
                                  np.asarray(jargs[1]))
    ours = fn(*args).numpy()
    assert ours.shape == (32, 32) and ours.dtype == np.int32
    np.testing.assert_array_equal(ours, np.asarray(jax.jit(jfn)(*jargs)))


@pytest.mark.parametrize("world", WORLDS)
def test_inputs_follow_the_jax_draw_order(runs, world):
    ours, ref = runs[0][world], runs[1][world]
    n = 4 * world
    assert int(ours["world"]) == world
    (seqs, pm), _, _ = ref["sharded_snp_matrix"][0]
    np.testing.assert_array_equal(ours["in/seqs"], seqs)
    np.testing.assert_array_equal(ours["in/pm"], pm)
    (Dsq,), _, _ = ref["dnj_joins"][0]
    np.testing.assert_array_equal(ours["in/Dsq"], Dsq)
    for (Dh,), _, _ in ref["hclust_joins"]:
        np.testing.assert_array_equal(ours["in/Dsq"], Dh)
    Dfull = ours["s1/D"].astype(np.float64)
    np.fill_diagonal(Dfull, 0.0)
    for (D,), _, _ in ref["sharded_join_records"] \
            + ref["sharded_dnj_records"]:
        np.testing.assert_array_equal(Dfull, D[:n, :n])
    (Dq,), _, _ = ref["pack_words"][0]
    np.testing.assert_array_equal(ours["in/Dq"], Dq)
    (Dq2,), _, _ = ref["dnj_joins_streamed"][0]
    np.testing.assert_array_equal(ours["in/Dq2"], Dq2)
    (Dq2p,), _, _ = ref["pack_words"][1]
    np.testing.assert_array_equal(ours["in/Dq2"], Dq2p)


@pytest.mark.parametrize("world", WORLDS)
def test_stage1_sharded_snp_matrix(runs, world):
    ours, ref = runs[0][world], runs[1][world]
    _, _, D = ref["sharded_snp_matrix"][0]
    assert ours["s1/D"].shape == D.shape == (4 * world, 4 * world)
    np.testing.assert_array_equal(ours["s1/D"], D)
    np.testing.assert_array_equal(ours["s1/D_single"], D)


@pytest.mark.parametrize("world", WORLDS)
def test_stage2_dnj(runs, world):
    ours, ref = runs[0][world], runs[1][world]
    (_, kw, rec), = ref["dnj_joins"]
    assert kw == {}  # the JAX default scan, "seq", as the port's stage
    T = 4 * world - 2
    _same(_port(ours, "s2/", ("I", "J", "LI", "LJ", "d_last")), rec[:5], T,
          "dnj")


@pytest.mark.parametrize("method", dryrun.NJ_METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_stage3_sharded_nj(runs, world, method):
    ours, ref = runs[0][world], runs[1][world]
    (rec,) = [r for _, kw, r in ref["sharded_join_records"]
              if kw["method"] == method]
    _same(_port(ours, f"s3/{method}/", ("I", "J", "LI", "LJ", "a", "b",
                                        "d_last")), rec, what=method)


@pytest.mark.parametrize("world", WORLDS)
def test_stage4_sharded_dnj(runs, world):
    ours, ref = runs[0][world], runs[1][world]
    (_, _, rec), = ref["sharded_dnj_records"]
    assert ours["s4/LI"].dtype == rec[2].dtype == np.float32
    _same(_port(ours, "s4/", ("I", "J", "LI", "LJ", "d_last")), rec,
          4 * world - 2, "sharded dnj")


@pytest.mark.parametrize("method", dryrun.HCLUST_METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_stage5_hclust(runs, world, method):
    ours, ref = runs[0][world], runs[1][world]
    (rec,) = [r for _, kw, r in ref["hclust_joins"]
              if kw["method"] == method]
    _same(_port(ours, f"s5/{method}/", ("I", "J", "LI", "LJ", "d_last")),
          rec[:5], 4 * world - 2, method)


@pytest.mark.parametrize("world", WORLDS)
def test_stage6_packed(runs, world):
    ours, ref = runs[0][world], runs[1][world]
    _, _, rec = ref["dnj_joins_packed"][0]
    _same(_port(ours, "s6/", dryrun.PACKED_RECORDS), rec[:6], 38, "packed")


@pytest.mark.parametrize("world", WORLDS)
def test_stage7_streamed_and_packed(runs, world):
    ours, ref = runs[0][world], runs[1][world]
    _, _, streamed = ref["dnj_joins_streamed"][0]
    _, _, packed = ref["dnj_joins_packed"][1]
    for side in ("streamed", "packed"):
        port = _port(ours, f"s7/{side}/", dryrun.PACKED_RECORDS)
        _same(port, packed[:6], 510, side + " == JAX packed")
        _same(port, streamed[:6], 510, side + " == JAX streamed")


@pytest.mark.parametrize("world", WORLDS)
def test_result_reports_seconds_and_launches(runs, world):
    ours = runs[0][world]
    for name in dryrun.STAGES:
        assert float(ours["seconds/" + name]) > 0, name
    launches = {k for k in ours if k.startswith("launches/")}
    assert {"launches/snp_expand_shared", "launches/dnj_segment",
            "launches/qrow_mins_slots"} <= launches
    # CPU tensors: every wrapper takes its plain version, no launch
    assert all(int(ours[k]) == 0 for k in launches)


def test_command_line(runs):
    p = runs[2]
    assert p.returncode == 0, p.stderr.decode(errors="replace")
    lines = p.stdout.decode().splitlines()
    assert lines[0].startswith("build: ")
    assert lines[1].startswith("entry: snp_matrix (32, 32) on cpu in ")
    for k, name in enumerate(dryrun.STAGES, 1):
        assert lines[1 + k].startswith(f"stage {k} {name}: "), lines
    assert lines[-1].startswith(f"dryrun_multichip({CLI_WORLD}) on cpu: "
                                "records equal on every rank")


def test_command_line_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "ccphylo_tpu_torch.dryrun"],
                       env=_env(), capture_output=True, timeout=120)
    assert p.returncode != 0
    assert b"torch.cuda.is_available() is False" in p.stderr
    assert p.stdout == b""


class _Ranks:
    """subprocess.Popen that keeps every process it starts, and runs
    `fake` in place of the rank whose CCPHYLO_TORCH_PROC_ID is 1."""

    def __init__(self, fake):
        self.procs, self.fake, self.popen = [], fake, subprocess.Popen

    def __call__(self, args, env=None, **kw):
        if env.get("CCPHYLO_TORCH_PROC_ID") == "1":
            args = [sys.executable, "-c", self.fake]
        p = self.popen(args, env=env, **kw)
        self.procs.append(p)
        return p


@pytest.mark.parametrize("fake,limit,error", [
    ("import sys; sys.exit(3)", 120.0, "rank 1 of 2 exited 3"),
    ("import time; time.sleep(600)", 4.0, "still running after 4.0 s")])
def test_failed_rank_or_time_limit_stops_every_rank(monkeypatch, fake,
                                                    limit, error):
    """Rank 0 runs for real and waits for its peer in the group; the
    launcher stops it when rank 1 exits non-zero or the time runs out."""
    ranks = _Ranks(fake)
    monkeypatch.setattr(subprocess, "Popen", ranks)
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError), match=error):
        dryrun.dryrun_multichip(2, limit, "cpu")
    assert time.monotonic() - t0 < 60
    assert len(ranks.procs) == 2
    assert all(p.poll() is not None for p in ranks.procs)


def test_cuda_world_above_the_card_count_raises_before_any_process(
        monkeypatch):
    started = []
    monkeypatch.setattr(subprocess, "Popen", lambda *a, **k: started.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("CCPHYLO_TORCH_DEVICE", "cuda")
    with pytest.raises(ValueError, match="needs 2 cards, this machine has 1"):
        dryrun.dryrun_multichip(2)
    assert started == []
