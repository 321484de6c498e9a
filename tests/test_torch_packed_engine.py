"""The port's packed exact-integer DNJ engine
(ccphylo_tpu_torch/tree/packed_engine.py, plain scan on the CPU) against
the JAX engine ccphylo_tpu.tree.packed_engine and the host exact -b
engine of both packages, with each of the engine's scans (`segment`,
one launch per segment of joins, the default; `fused`, one launch per
join; `passes`, the host-driven loop over qrow_mins; `plain`) and join
bodies (`kernel`, one launch per join or per segment; `plain`).
Everything compared is an integer or the bytes of a Newick string, so
every comparison is bit-exact (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccphylo_tpu.tree.packed_engine as jpe
import ccphylo_tpu_torch.tree.packed_engine as tpe
from ccphylo_tpu.io.qseqs import Name
from ccphylo_tpu.tree.exact import build_tree
from ccphylo_tpu_torch.interop import state_from_jax
from ccphylo_tpu_torch.io.qseqs import Name as PortName
from ccphylo_tpu_torch.tree.exact import build_tree as port_build_tree
from ccphylo_tpu_torch.tree import segmenting

REC = ("I", "J", "DIJ2", "SDI2", "SDJ2")

# Small shapes: one intra-op thread.  The JAX CPU backend's worker
# threads share the cores in this process, and torch's OpenMP pool
# then stalls on every small op of the engine loop.
torch.set_num_threads(1)


def _square(qv, n, npad):
    Dq = np.zeros((npad, npad), np.uint8)
    iu = np.tril_indices(n, -1)
    Dq[(iu[0], iu[1])] = qv
    Dq[(iu[1], iu[0])] = qv
    return Dq


def _port(Dq, n, **kw):
    out = tpe.dnj_joins_packed(tpe.pack_words(Dq.copy(), "cpu"), n, **kw)
    k = n - 2
    recs = [np.asarray(x.numpy())[:k].copy() for x in out[:5]]
    return recs, int(out[5]), out[6].numpy().view(np.uint32)


def _jax(Dq, n, **kw):
    out = jpe.dnj_joins_packed(jpe.pack_words(Dq.copy()), jnp.int32(n),
                               **kw)
    k = n - 2
    recs = [np.asarray(x)[:k].copy() for x in out[:5]]
    return recs, int(np.asarray(out[5])), np.asarray(out[6])


def _assert_same(a, b):
    for name, x, y in zip(REC, a[0], b[0]):
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a[1] == b[1]  # d_last2


@pytest.mark.parametrize("n,seed,hi", [(100, 100, 200), (257, 257, 200),
                                       (120, 7, 6)])  # last: tie-dense
def test_records_match_jax_engine(n, seed, hi):
    rng = np.random.RandomState(seed)
    qv = rng.randint(0, hi, n * (n - 1) // 2).astype(np.uint8)
    Dq = _square(qv, n, tpe.pad_packed(n))
    ours, ref = _port(Dq, n), _jax(Dq, n)
    _assert_same(ours, ref)
    # the final byte matrix too: same in-place updates, incl. popArrange
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_array_equal(tpe.dnj_joins_packed.last_stats,
                                  jpe.dnj_joins_packed.last_stats)


@pytest.mark.parametrize("body", sorted(tpe.BODIES))
@pytest.mark.parametrize("scan", sorted(tpe.SCANS))
@pytest.mark.parametrize("kbatch", [128, 8])
def test_every_scan_matches_jax_engine(scan, kbatch, body):
    """Records, the final byte matrix and the scan statistics (passes,
    changed rows) of each scan, under each join body, equal the JAX
    engine's, also where a join takes several passes (kbatch 8)."""
    n = 150
    rng = np.random.RandomState(21)
    qv = rng.randint(0, 40, n * (n - 1) // 2).astype(np.uint8)
    Dq = _square(qv, n, tpe.pad_packed(n))
    ours = _port(Dq, n, kbatch=kbatch, scan=scan, body=body)
    stats = tpe.dnj_joins_packed.last_stats.copy()
    ref = _jax(Dq, n, kbatch=kbatch)
    _assert_same(ours, ref)
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_array_equal(stats, jpe.dnj_joins_packed.last_stats)
    assert stats[0] > (n - 2 if kbatch == 8 else 0)


def test_unknown_scan_is_refused():
    Dq = _square(np.ones(45, np.uint8), 10, tpe.pad_packed(10))
    with pytest.raises(ValueError, match="fused"):
        _port(Dq, 10, scan="nope")


def test_unknown_body_is_refused():
    Dq = _square(np.ones(45, np.uint8), 10, tpe.pad_packed(10))
    with pytest.raises(ValueError, match="kernel"):
        _port(Dq, 10, body="nope")


def test_records_stay_tensors_and_default_body(monkeypatch):
    """The engine keeps I and J as tensors on the device of `words` (the
    records are never copied to the host between fences); by default it
    runs each segment as one call of the segment kernel's wrapper, with
    scan="fused" the kernel body once a join, and the plain body with
    the plain scan."""
    n = 40
    rng = np.random.RandomState(3)
    Dq = _square(rng.randint(0, 30, n * (n - 1) // 2).astype(np.uint8), n,
                 tpe.pad_packed(n))
    seen = []

    def spy(table, name):
        fn = getattr(tpe, table)[name]

        def body(*a, **kw):
            seen.append((table, name, type(a[5]), type(a[6])))
            return fn(*a, **kw)
        return body

    for table in ("BODIES", "SEGMENTS"):
        monkeypatch.setattr(tpe, table, {k: spy(table, k)
                                         for k in getattr(tpe, table)})
    ref = _port(Dq, n, scan="plain")
    assert {s[:2] for s in seen} == {("BODIES", "plain")}
    seen.clear()
    _assert_same(_port(Dq, n), ref)
    assert [s[:2] for s in seen] == [("SEGMENTS", "kernel")]  # one segment
    seen.clear()
    _assert_same(_port(Dq, n, scan="fused"), ref)
    assert {s[:2] for s in seen} == {("BODIES", "kernel")} \
        and len(seen) == n - 2
    assert {s[2:] for s in seen} == {(torch.Tensor, torch.Tensor)}


def test_kbatch_invariance():
    rng = np.random.RandomState(11)
    n = 200
    qv = np.clip(np.floor(rng.uniform(0.1, 12.0, n * (n - 1) // 2) * 16
                          + 0.5), 0, 255).astype(np.uint8)
    Dq = _square(qv, n, tpe.pad_packed(n))
    _assert_same(_port(Dq, n, kbatch=32), _port(Dq, n, kbatch=128))


@pytest.mark.parametrize("seed", range(2))
def test_newick_matches_host_exact_b(seed):
    n = 48
    rng = np.random.RandomState(seed)
    flat = rng.uniform(0.1, 12.0, n * (n - 1) // 2)
    bs = 16.0
    exact = build_tree(flat.copy(), n,
                       [Name(b"t%03d" % i, 32) for i in range(n)], "dnj",
                       dtype="b", bytescale=bs)
    ours = tpe.build_tree_packed(flat.copy(), n,
                                 [Name(b"t%03d" % i, 32) for i in range(n)],
                                 bytescale=bs, device="cpu")
    assert ours == exact
    # the port's own host engine and names, and the passes scan
    port_exact = port_build_tree(
        flat.copy(), n, [PortName(b"t%03d" % i, 32) for i in range(n)],
        "dnj", dtype="b", bytescale=bs)
    passes = tpe.build_tree_packed(
        flat.copy(), n, [PortName(b"t%03d" % i, 32) for i in range(n)],
        bytescale=bs, device="cpu", scan="passes")
    assert port_exact == exact and passes == exact


class _Killed(Exception):
    pass


def _killer(state, done, total):
    if done >= 64:
        raise _Killed  # a crash after a mid-run snapshot


def _no_init(*a, **kw):
    raise AssertionError("init re-ran on resume")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_resume_from_checkpoint(tmp_path, monkeypatch, writer):
    """A run killed after a mid-run snapshot — written by the JAX engine
    or by the port, in the same npz format — resumes in the port and
    gives the records of an uninterrupted run, without re-running
    init."""
    n = 220
    rng = np.random.RandomState(5)
    qv = rng.randint(0, 30, n * (n - 1) // 2).astype(np.uint8)
    Dq = _square(qv, n, tpe.pad_packed(n))
    ref = _port(Dq, n)

    ck = str(tmp_path / "dnj.ckpt.npz")
    if writer == "jax":
        monkeypatch.setenv("CCPHYLO_TPU_CKPT", ck)
        monkeypatch.setenv("CCPHYLO_TPU_CKPT_EVERY_S", "0")
        monkeypatch.setenv("CCPHYLO_TPU_SEG", "64")
        monkeypatch.setenv("CCPHYLO_TPU_SEG_FIXED", "1")
        with pytest.raises(_Killed):
            _jax(Dq, n, hooks=_killer)
    else:
        monkeypatch.setenv("CCPHYLO_TORCH_CKPT", ck)
        monkeypatch.setenv("CCPHYLO_TORCH_CKPT_EVERY_S", "0")
        monkeypatch.setattr(segmenting, "SEG", 64)
        with pytest.raises(_Killed):
            _port(Dq, n, hooks=_killer)

    st, done = state_from_jax(ckpt=ck)["ckpt"]
    assert done >= 64
    np.testing.assert_array_equal(st["I"][:done], ref[0][0][:done])
    assert st["words"].shape == (512, 128)

    monkeypatch.setenv("CCPHYLO_TORCH_CKPT", ck)
    monkeypatch.setattr(tpe, "_packed_init", _no_init)
    _assert_same(_port(Dq, n), ref)
    assert not (tmp_path / "dnj.ckpt.npz").exists()  # cleaned up


@pytest.mark.parametrize("writer,reader", [("fused", "passes"),
                                           ("passes", "fused"),
                                           ("segment", "fused"),
                                           ("fused", "segment")])
def test_resume_across_scans(tmp_path, monkeypatch, writer, reader):
    """A snapshot written under one scan resumes under the other and
    gives the uninterrupted records and statistics."""
    n = 220
    rng = np.random.RandomState(8)
    qv = rng.randint(0, 30, n * (n - 1) // 2).astype(np.uint8)
    Dq = _square(qv, n, tpe.pad_packed(n))
    ref = _port(Dq, n, kbatch=16, scan="plain")
    stats = tpe.dnj_joins_packed.last_stats.copy()
    monkeypatch.setenv("CCPHYLO_TORCH_CKPT", str(tmp_path / "x.npz"))
    monkeypatch.setenv("CCPHYLO_TORCH_CKPT_EVERY_S", "0")
    monkeypatch.setattr(segmenting, "SEG", 64)
    with pytest.raises(_Killed):
        _port(Dq, n, kbatch=16, scan=writer, hooks=_killer)
    monkeypatch.setattr(tpe, "_packed_init", _no_init)
    _assert_same(_port(Dq, n, kbatch=16, scan=reader), ref)
    np.testing.assert_array_equal(tpe.dnj_joins_packed.last_stats, stats)


def test_jax_engine_resumes_port_checkpoint(tmp_path, monkeypatch):
    """The port's snapshot is in the JAX engine's format: the JAX engine
    resumes from it and gives the uninterrupted records."""
    n = 220
    rng = np.random.RandomState(6)
    qv = rng.randint(0, 30, n * (n - 1) // 2).astype(np.uint8)
    Dq = _square(qv, n, tpe.pad_packed(n))
    ref = _jax(Dq, n)
    ck = str(tmp_path / "dnj.ckpt.npz")
    monkeypatch.setenv("CCPHYLO_TORCH_CKPT", ck)
    monkeypatch.setenv("CCPHYLO_TORCH_CKPT_EVERY_S", "0")
    monkeypatch.setattr(segmenting, "SEG", 64)
    with pytest.raises(_Killed):
        _port(Dq, n, hooks=_killer)
    monkeypatch.setenv("CCPHYLO_TPU_CKPT", ck)
    monkeypatch.setattr(jpe, "_packed_init", _no_init)
    _assert_same(_jax(Dq, n), ref)
