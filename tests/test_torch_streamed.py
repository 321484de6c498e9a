"""The port's row-cache DNJ engine (tree/streamed_engine.py) on CPU
tensors against the JAX package's tree/streamed_engine.py and the
port's own packed engine, on the same seeded u8 matrices.

Tolerance 0 everywhere: every quantity is an int32 multiple of
1/(2*ByteScale), so the six record arrays and the final host matrix
must be equal at any cache size; the cache only decides when a row is
read.  The JAX engine runs once per matrix (a module fixture): each of
its runs compiles a segment program per upload shape."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks.synth import cell_hash_np
from ccphylo_tpu.tree import streamed_engine as jse
from ccphylo_tpu_torch import interop
from ccphylo_tpu_torch.native import get_lib
from ccphylo_tpu_torch.ops.scan import qrow_mins, qrow_mins_plain
from ccphylo_tpu_torch.tree import packed_engine as pe
from ccphylo_tpu_torch.tree import streamed_engine as se

torch.set_num_threads(1)

N = 600
NAMES = ("I", "J", "DIJ2", "SDI2", "SDJ2")


def _metric_matrix(npad, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, npad)
    Dq = np.minimum(np.round(np.abs(x[:, None] - x[None, :]) * 180) + 3,
                    255).astype(np.uint8)
    np.fill_diagonal(Dq, 0)
    return Dq


def _hash_matrix(npad, mod=97):
    ii, jj = np.meshgrid(np.arange(npad, dtype=np.uint32),
                         np.arange(npad, dtype=np.uint32), indexing="ij")
    return cell_hash_np(ii, jj, mod)


def _matrix(data, n=N):
    """The two matrices of tests/test_streamed_engine.py: metric data
    (misses, evictions) and tie-dense hash data."""
    npad = pe.pad_packed(n)
    Dq = _metric_matrix(npad) if data == "metric" else _hash_matrix(npad)
    Dq[n:, :] = 0
    Dq[:, n:] = 0
    return Dq


def _packed(Dq, n):
    out = pe.dnj_joins_packed(pe.pack_words(Dq.copy(), "cpu"), n)
    recs = [a.numpy()[:n - 2] for a in out[:5]]
    return recs, int(out[5]), out[6].view(torch.uint8).numpy()


@pytest.fixture(scope="module")
def packed_runs():
    return {d: _packed(_matrix(d), N) for d in ("metric", "hash")}


@pytest.fixture(scope="module")
def jax_runs():
    """One run of the JAX engine per matrix: records, d_last2 and the
    final host matrix."""
    out = {}
    for data, X, F in (("metric", 384, 48), ("hash", 600, 64)):
        Dq = _matrix(data)
        *recs, dl2 = jse.dnj_joins_streamed(Dq, N, X=X, F=F)
        out[data] = ([np.asarray(a)[:N - 2] for a in recs], int(dl2), Dq)
    return out


@pytest.mark.parametrize("data,X", [("metric", 384), ("metric", 600),
                                    ("hash", 600), ("hash", 384)])
def test_records_match_jax_and_packed(jax_runs, packed_runs, data, X):
    Dq = _matrix(data)
    *recs, dl2 = se.dnj_joins_streamed(Dq, N, X=X, device="cpu")
    eng = se.dnj_joins_streamed.last
    for ref, ref_dl2, ref_D in (jax_runs[data], packed_runs[data]):
        for name, ours, theirs in zip(NAMES, recs, ref[:5]):
            np.testing.assert_array_equal(ours[:N - 2], theirs, err_msg=name)
        assert dl2 == ref_dl2
        # the part of the matrix that is still active
        np.testing.assert_array_equal(Dq[:2, :2], ref_D[:2, :2])
    # against the packed engine every byte agrees, joined-away rows too
    np.testing.assert_array_equal(Dq, packed_runs[data][2])
    assert eng.stats[0] > 0 and eng.stats[2] == eng.aborts
    assert eng.uploaded_bytes == eng.uploaded_rows * Dq.shape[0]
    if X < N:
        # the small cache was really exercised
        assert eng.aborts >= 1 and eng.uploaded_rows > N
    assert (eng.rowof_h >= 0).sum() <= 2 + 1  # joined-away rows free slots


def test_small_cache_gives_the_same_records(packed_runs):
    Dq = _matrix("metric")
    *recs, dl2 = se.dnj_joins_streamed(Dq, N, X=256, device="cpu")
    ref, ref_dl2, ref_D = packed_runs["metric"]
    for name, ours, theirs in zip(NAMES, recs, ref):
        np.testing.assert_array_equal(ours[:N - 2], theirs, err_msg=name)
    assert dl2 == ref_dl2 and np.array_equal(Dq, ref_D)
    eng = se.dnj_joins_streamed.last
    assert eng.aborts >= 1 and 0 < eng.times["replay_s"] < eng.times["run_s"]


def test_livelock_guard():
    """A cache smaller than what one scan pass needs at once raises the
    documented error, and does not hang."""
    with pytest.raises(RuntimeError, match="livelock"):
        se.dnj_joins_streamed(_matrix("hash"), N, X=64, F=16, device="cpu")


@pytest.mark.parametrize("n,m", [(512, 500), (1024, 1024), (512, 2),
                                 (512, 3)])
def test_native_host_init_parity(n, m):
    """init_hnj_u8 against the numpy form, and both against the JAX
    package's and the packed engine's init, on tie-dense data with
    padded rows."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.RandomState(n + m)
    Dq = rng.randint(0, 7, (n, n)).astype(np.uint8)
    Dq = np.minimum(Dq, Dq.T)
    np.fill_diagonal(Dq, 0)
    Dq[m:, :] = 0
    Dq[:, m:] = 0
    a = se._host_init(Dq, m)
    b = se._host_init_np(Dq, m)
    c = jse._host_init_np(Dq, m)
    for x, y, z in zip(a[:3], b[:3], c[:3]):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert a[3] == b[3] == c[3]
    sD2, Q, P, seed = pe._packed_init(pe.pack_words(Dq, "cpu"), m)
    np.testing.assert_array_equal(a[0][:m], sD2.numpy()[:m])
    np.testing.assert_array_equal(a[1], Q.numpy())
    assert a[3] == int(seed)


def test_memmap_matrix(tmp_path):
    n = 200
    Dq = _matrix("metric", n)
    recs, dl2, D_end = _packed(Dq, n)
    mm = np.memmap(tmp_path / "d.u8", dtype=np.uint8, mode="w+",
                   shape=Dq.shape)
    mm[:] = Dq
    *ours, dl2_o = se.dnj_joins_streamed(mm, n, X=96, kbatch=32,
                                         device="cpu")
    for name, a, b in zip(NAMES, ours, recs):
        np.testing.assert_array_equal(a[:n - 2], b, err_msg=name)
    assert dl2_o == dl2
    np.testing.assert_array_equal(np.asarray(mm), D_end)
    assert se.dnj_joins_streamed.last.aborts >= 1


def test_stop_and_go_on(packed_runs):
    """run(stop=...) and run(state=..., start=...) split a run without a
    trace, with another cache policy history on each side."""
    Dq = _matrix("hash")
    eng = se.StreamedDNJ(Dq, N, X=300, device="cpu")
    half = 250
    out = eng.run(stop=half)
    assert out[5] is None
    eng2 = se.StreamedDNJ(Dq, N, X=300, device="cpu")
    *recs, dl2 = eng2.run(state=eng.state(), start=half)
    ref, ref_dl2, ref_D = packed_runs["hash"]
    for name, ours, theirs in zip(NAMES, recs, ref):
        np.testing.assert_array_equal(ours[:N - 2], theirs, err_msg=name)
    assert dl2 == ref_dl2 and np.array_equal(Dq, ref_D)


def test_go_on_from_a_jax_state():
    """interop.streamed_state_from_jax: the JAX engine runs the first
    half of the joins (one segment program, every row resident), the
    port the rest, from the JAX state and the replayed host matrix."""
    n, X, half = 200, 512, 90
    Dq = _matrix("metric", n)
    npad = Dq.shape[0]
    recs, dl2, D_end = _packed(Dq, n)
    jeng = jse.StreamedDNJ(Dq, n, X=X)
    sD2, Q, P, seed = jse._host_init(Dq, n)
    # the segment donates its state: one buffer per entry
    z = [jnp.zeros(npad, jnp.int32) + 0 for _ in range(5)]
    state = (jnp.zeros((X, npad // 4), jnp.uint32),
             jnp.full(npad, -1, jnp.int32), jnp.full(X, -1, jnp.int32),
             jnp.asarray(sD2), jnp.asarray(Q), jnp.asarray(P),
             jnp.int32(seed), *z, jnp.zeros(8, jnp.int32),
             jnp.int32(0), jnp.bool_(True),
             jnp.full(jse.MMAX, -1, jnp.int32))
    up3, u = jeng._plan_upload(list(range(n)))
    assert u == n
    state = jse._streamed_segment(*state, *up3, jnp.int32(half),
                                  jnp.int32(n), n=npad, X=X, kbatch=128)
    state = [np.asarray(x) for x in state]
    assert int(state[13]) == half and bool(state[14])
    st, t = interop.streamed_state_from_jax(state, "cpu")
    assert t == half
    se._host_replay_shift(Dq, st["I"], st["J"], 0, half, n)
    eng = se.StreamedDNJ(Dq, n, X=X, device="cpu")
    *ours, dl2_o = eng.run(state=st, start=half)
    for name, a, b in zip(NAMES, ours, recs):
        np.testing.assert_array_equal(a[:n - 2], b, err_msg=name)
    assert dl2_o == dl2
    np.testing.assert_array_equal(Dq[:2, :2], D_end[:2, :2])


def test_replay_mirrors_equal_the_jax_replay():
    """`_replay_join_mirrored` of both packages on the same joins: the
    matrix, the sD2/Q/P mirrors and the rows reported as lowered."""
    n = 120
    Dq = _matrix("hash", n)
    recs, _, _ = _packed(Dq, n)
    A, B = Dq.copy(), Dq.copy()
    ma = [x.copy() for x in se._host_init_np(A, n)[:3]]
    mb = [x.copy() for x in ma]
    idx, big = np.arange(Dq.shape[0]), np.int32(2 ** 31 - 1)
    for t in range(60):
        i, j = int(recs[0][t]), int(recs[1][t])
        ha = se._replay_join_mirrored(A, *ma, i, j, n - t, idx, big)
        hb = jse._replay_join_mirrored(B, *mb, i, j, n - t, idx, big)
        assert ha == hb
    np.testing.assert_array_equal(A, B)
    for x, y in zip(ma, mb):
        np.testing.assert_array_equal(x, y)
    C = se._host_replay_shift(Dq.copy(), recs[0], recs[1], 0, 60, n)
    np.testing.assert_array_equal(C, A)


@pytest.mark.parametrize("data", ["metric", "hash"])
def test_native_replay_parity(data):
    """replay_join_u8 against the numpy form on every join of a run:
    the matrix, the three mirrors and the lowered rows, int32 wraparound
    included (the mirrors start from wrapped garbage)."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    n = 150
    Dq = _matrix(data, n)
    recs, _, _ = _packed(Dq, n)
    A, B = Dq.copy(), Dq.copy()
    ma = [x.copy() for x in se._host_init_np(A, n)[:3]]
    ma[0] += np.int32(2 ** 31 - 5000)  # sums that wrap
    mb = [x.copy() for x in ma]
    idx, big = np.arange(Dq.shape[0]), np.int32(2 ** 31 - 1)
    for t in range(n - 2):
        i, j = int(recs[0][t]), int(recs[1][t])
        ha = se._replay_join(A, *ma, i, j, n - t, idx)
        hb = se._replay_join_mirrored(B, *mb, i, j, n - t, idx, big)
        assert list(ha) == list(hb), t
        for x, y in zip([A] + ma, [B] + mb):
            np.testing.assert_array_equal(x, y, err_msg=str(t))


def test_qrow_mins_with_slots():
    """qrow_mins with the slot argument against the slot-free call on
    the gathered rows; a row that is not resident is a row without
    columns, as padding is."""
    rng = np.random.RandomState(5)
    n, X = 256, 96
    D = rng.randint(0, 256, (n, n)).astype(np.uint8)
    words = torch.from_numpy(D).view(torch.int32)
    sd2 = torch.from_numpy(rng.randint(0, 1 << 20, n).astype(np.int32))
    resident = rng.permutation(n)[:X]
    slotof = np.full(n, -1, np.int32)
    slotof[resident] = rng.permutation(X).astype(np.int32)
    cache = np.zeros((X, n), np.uint8)
    cache[slotof[resident]] = D[resident]
    cache_w = torch.from_numpy(cache).view(torch.int32)
    slots = torch.from_numpy(slotof)
    rows = np.concatenate([resident[:40], [0, 0], resident[:6]]) \
        .astype(np.int32)
    rows_t = torch.from_numpy(rows)
    co = 2 * (n - 2)
    want = qrow_mins_plain(rows_t, co, words, sd2)
    for fn in (qrow_mins_plain, qrow_mins):
        got = fn(rows_t, co, cache_w, sd2, slots=slots)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    absent = np.setdiff1d(np.arange(1, n), resident)[:5].astype(np.int32)
    rmin, rarg = qrow_mins(torch.from_numpy(absent), co, cache_w, sd2,
                           slots=slots)
    assert (rmin == 2 ** 31 - 1).all() and (rarg == n - 1).all()


def test_default_device_is_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("CCPHYLO_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        se.dnj_joins_streamed(_matrix("metric", 100), 100, X=64)
