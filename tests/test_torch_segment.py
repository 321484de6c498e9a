"""A segment of joins of the port's packed DNJ engine (ccphylo_tpu_torch/
ops/segment.py, plain versions on the CPU).  `dnj_segment_plain` over
[t0, t1) from a state of a run of the JAX packed engine gives that
engine's state at t1; a numpy model of csrc/dnj_segment.cu (the CUDA
kernel cannot run here) gives `dnj_segment_plain`'s state over whole
segments, on states of JAX runs and on random states.  The model runs
the kernel's G blocks as generators that stop at every grid barrier,
the blocks in a random order between barriers and the threads of a
block in a random order within a phase, with the kernel's ownership
partition, the scan's two result buffers by a parity that runs on
across joins, the copy of Q in shared memory with its patches, and
phase C reduced in every block; with one barrier taken out, or Q copied
before the barrier, the same model differs from the plain loop on some
seeded state, so the model can see such a fault.  The wrapper's
argument checks refuse what the kernel does not take.  Everything is an
integer: tolerance 0."""

import numpy as np
import pytest
import torch

from ccphylo_tpu_torch.ops import segment

from .torch_states import jax_states, port_state

IBIG = 2 ** 31 - 1
KEYS = ("words", "sD2", "Q", "P", "seed", "I", "J", "DIJ2", "SDI2", "SDJ2",
        "stats")
THREADS = 256  # threads of a block of dnj_segment_kernel

# Small shapes: one intra-op thread.  The JAX CPU backend's worker
# threads share the cores in this process, and torch's OpenMP pool
# then stalls on every small op of the engine loop.
torch.set_num_threads(1)


def _numpy(st):
    out = {k: st[k].numpy().copy() for k in KEYS}
    out["words"] = out["words"].view(np.uint8)
    return out


def _assert_state(ours, want, msg):
    for k in KEYS:
        a, b = np.asarray(ours[k]), np.asarray(want[k])
        if k == "words":
            a, b = a.view(np.uint8), b.view(np.uint8)
        np.testing.assert_array_equal(a.reshape(-1), b.reshape(-1),
                                      err_msg=f"{k} {msg}")


def _cuts(rng, t0, t1):
    """Random segment boundaries over [t0, t1), empty segments too."""
    inner = sorted(rng.choice(np.arange(t0, t1 + 1), 3).tolist())
    return list(zip([t0] + inner, inner + [t1]))


# ---------------------------------------------------------------------
# the plain loop against the JAX engine


@pytest.mark.parametrize("n,seed,hi,K", [(70, 3, 3, 4), (200, 5, 6, 128),
                                         (70, 8, 200, 4), (70, 3, 200, 128),
                                         (70, 4, 6, 8), (200, 5, 40, 4),
                                         (300, 6, 3, 2)])
def test_dnj_segment_plain_matches_jax_engine(n, seed, hi, K):
    """`dnj_segment_plain` over segments [t0, t1) of a run, from the JAX
    engine's state at t0, gives its state at t1, every array; the run
    met a popArrange from the last row (i == last), neighbouring rows
    (i == j + 1) and the last join (m_t == 3)."""
    states = jax_states(n, seed, hi, K)
    rng = np.random.default_rng(seed)
    met = {"i == last": 0, "i == j + 1": 0, "m_t == 3": 0}
    for t0, t1 in _cuts(rng, 0, n - 2):
        st = port_state(states[t0][1])
        segment.dnj_segment_plain(*(st[k] for k in KEYS), t0, t1, n, K)
        _assert_state(_numpy(st), states[t1][1], f"after [{t0}, {t1})")
    final = states[-1][1]
    for t in range(n - 2):
        i, j, m_t = int(final["I"][t]), int(final["J"][t]), n - t
        met["i == last"] += i == m_t - 1
        met["i == j + 1"] += i == j + 1
        met["m_t == 3"] += m_t == 3
    assert all(met.values()), met


# ---------------------------------------------------------------------
# a model of the kernel


def _wrap(x):
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _take(best, cand):
    """The better (value, index): smaller value, then larger index."""
    (v, x), (ov, ox) = best, cand
    return cand if ov < v or (ov == v and ox > x) else best


class _Diverged(Exception):
    """The blocks reached different barriers: the card would hang."""


def _row_min(D, sd2, r, co):
    q = (co * D[r, :r].astype(np.int64) - int(sd2[r])
         - sd2[:r].astype(np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31
    rmin = int(q.min())
    return rmin, (D.shape[0] - 1 if rmin == IBIG
                  else int(np.flatnonzero(q == rmin).max()))


def _block(k, S, sh, t0, t1, m, G, rng, stage, drop, early_copy):
    """The program of block k of dnj_segment_kernel on the numpy state S
    (shared by the blocks, as device memory is); `sh` holds the scratch
    (scan buffers, partials).  Yields the name of each grid barrier it
    reaches; `drop` names one to leave out; `early_copy` copies Q for
    the next join before the body's second barrier instead of after."""
    D, sd2, Q, P = S["words"], S["sD2"], S["Q"], S["P"]
    n = D.shape[0]
    stride = G * THREADS
    threads = [g for g in range(k * THREADS, (k + 1) * THREADS) if g < n]
    lead = k == 0
    # thread 0's registers and the block's shared memory
    seed = int(S["seed"].reshape(-1)[0])
    Qs = Q.copy() if stage else None
    patches = []
    par, npass_all, nchanged = 0, 0, 0

    def in_order(tasks):
        for x in rng.permutation(len(tasks)):
            tasks[x]()

    for t in range(t0, t1):
        m_t = m - t
        co, last, co_post = 2 * (m_t - 2), m_t - 1, 2 * (m_t - 3)
        if stage:
            for idx, val in patches:
                Qs[idx] = val
        view = Qs if stage else Q
        qs = int(view[seed])
        ok = seed != 0 and qs != IBIG
        minv, pi, pj = (qs, seed, int(P[seed])) if ok else (IBIG, 0, 0)

        # the scan's passes
        hi, npass = m_t, 0
        while True:
            view = Qs if stage else Q
            h = max(hi, 1)  # (a stale bound below 1 holds no group)
            rows = np.arange(1, h)[view[1:h] < minv][::-1]
            total = len(rows)
            if total == 0:
                break
            valid = k < total
            r = int(rows[k]) if valid else -1
            rmin, rarg = _row_min(D, sd2, r, co) if valid else (IBIG, -1)
            buf = sh["scan"][par]
            buf[:, k] = rmin, rarg, r
            if drop != "pass":
                yield "pass"
            par ^= 1
            # warp 0's reductions (order-exact): the minimum before k, and
            # the smallest rmin, ties to the larger row
            before = min([minv] + buf[0, :k].tolist())
            bv = int(buf[0].min())
            at = int(np.flatnonzero(buf[0] == bv)[np.argmax(
                buf[2][buf[0] == bv])])
            br, ba = int(buf[2, at]), int(buf[1, at])
            if valid:
                qr = int(Q[r])
                if qr < before:
                    Q[r], P[r] = rmin, rarg
                    nchanged += rmin != qr
            if bv < minv:
                minv, pi, pj = bv, br, ba
            npass += 1
            if total <= G:
                break
            hi = int(buf[2, G - 1])
        npass_all += npass

        i, j = pi, pj
        if i == 0 and j == 0:  # no joinable pair
            if lead:
                for key in ("I", "J", "DIJ2", "SDI2", "SDJ2"):
                    S[key][t] = 0
            if drop != "nopair":
                yield "nopair"
            Q[last] = IBIG
            seed, patches = 0, [(last, IBIG)]
            if stage:
                Qs = Q.copy()
            continue
        cij = int(D[i, j])

        # (A) records, updateD
        dsum = [0]

        def lead_a():
            S["I"][t], S["J"][t] = i, j
            S["DIJ2"][t] = 2 * cij
            S["SDI2"][t], S["SDJ2"][t] = sd2[i], sd2[j]

        def thread_a(g):
            for kk in range(g, m_t, stride):
                if kk in (i, j):
                    continue
                ci, cj = int(D[i, kk]), int(D[j, kk])
                d = max(ci + cj - cij, 0)
                sd2[kk] = _wrap(int(sd2[kk]) - (2 * ci + 2 * cj - d))
                dsum[0] += d
                D[j, kk] = D[kk, j] = min((2 * d + 1) >> 2, 255)

        in_order(([lead_a] if lead else [])
                 + [lambda g=g: thread_a(g) for g in threads])
        sh["part"][k] = dsum[0]
        if drop != "A":
            yield "A"

        # (B) sD2[j], the repairs of rows and columns j and i, popArrange
        sdj = _wrap(sum(int(x) for x in sh["part"]))
        pop = i != last
        sdl = int(sd2[last])
        red = [(IBIG, -1)] * 4  # row j, column j, row i, column i

        def lead_b():
            sd2[j] = sdj
            if pop:
                sd2[i] = sdl

        def thread_b(g):
            for kk in range(g, n, stride):
                sk = sdj if kk == j else (int(sd2[kk]) if kk < m_t
                                          and kk != i else 0)
                qk = None
                if kk < j or (j < kk < m_t and kk != i):
                    q = _wrap(co_post * int(D[j, kk]) - sdj - sk)
                    if kk < j:
                        red[0] = _take(red[0], (q, kk))
                    else:
                        qk = int(Q[kk])
                        if q <= qk:
                            Q[kk] = qk = q
                            P[kk] = j
                            red[1] = _take(red[1], (q, kk))
                if pop:
                    v = 0 if kk == i else int(D[last, kk])
                    D[i, kk] = D[kk, i] = v
                    q = _wrap(co_post * v - sdl - sk)
                    if kk < i:
                        red[2] = _take(red[2], (q, kk))
                    elif i < kk < last and q <= qk:
                        Q[kk] = q
                        P[kk] = i
                        red[3] = _take(red[3], (q, kk))

        in_order(([lead_b] if lead else [])
                 + [lambda g=g: thread_b(g) for g in threads])
        sh["red"][:, :, k] = red
        if stage and early_copy:
            Qs = Q.copy()
        if drop != "B":
            yield "B"
        if stage and not early_copy:
            Qs = Q.copy()

        # (C) in every block: the reductions, Q and P of rows j and i,
        # the seed
        best = []
        for rr in range(4):  # (min, largest index at it): order-exact
            v, x = sh["red"][rr]
            best.append((int(v.min()), int(x[v == v.min()].max())))
        Qj = best[0][0]
        Q[j], P[j] = Qj, 0 if Qj == IBIG else best[0][1]
        patches = [(j, Qj)]
        mi = best[1][1] if best[1][1] >= 0 and best[1][0] <= Qj else j
        mj = 0
        if pop:
            Qi = best[2][0]
            Q[i], P[i] = Qi, 0 if Qi == IBIG else best[2][1]
            patches.append((i, Qi))
            mj = best[3][1] if best[3][1] >= 0 and best[3][0] <= Qi else i
        Q[last] = IBIG
        patches.append((last, IBIG))
        qmj, qmi = int(Q[mj]), int(Q[mi])
        if mj == last:
            seed = mi
        elif mi == last:
            seed = mj
        else:
            seed = mj if qmj < qmi or (mi < mj and qmj == qmi) else mi
    S["stats"][1] += nchanged
    if lead:
        S["stats"][0] += npass_all
        S["seed"][...] = seed


def _segment_model(S, t0, t1, m, G, rng, stage=True, drop=None,
                   early_copy=False):
    """csrc/dnj_segment.cu's launch over joins [t0, t1) on the numpy
    state S, in place: G blocks, each run up to its next grid barrier in
    a random order of the blocks; raises _Diverged where the blocks
    reach different barriers."""
    sh = {"scan": np.zeros((2, 3, G), np.int64),
          "part": np.zeros(G, np.int64),
          "red": np.zeros((4, 2, G), np.int64)}
    live = [_block(k, S, sh, t0, t1, m, G, rng, stage, drop, early_copy)
            for k in range(G)]
    while live:
        reached, nxt = set(), []
        for x in rng.permutation(len(live)):
            try:
                reached.add(next(live[x]))
                nxt.append(live[x])
            except StopIteration:
                reached.add(None)
        if len(reached) > 1:
            raise _Diverged(reached)
        live = nxt


def _model_state(st):
    S = _numpy(st)
    S["seed"] = S["seed"].reshape(1)
    return S


@pytest.mark.parametrize("stage", [True, False])
@pytest.mark.parametrize("n,seed,hi,K", [(70, 3, 3, 4), (200, 5, 6, 128),
                                         (70, 3, 200, 128), (70, 4, 6, 8),
                                         (200, 5, 40, 4), (300, 6, 3, 2)])
def test_dnj_segment_kernel_model_matches_plain(n, seed, hi, K, stage):
    """The kernel's decomposition over whole segments of a JAX run (with
    Q copied to shared memory or read from L2) gives
    `dnj_segment_plain`'s state, whatever order the blocks and threads
    run in, stale caches and ties included; with K <= 8 some join takes
    several passes, so the bounded walks after the first are taken."""
    states = jax_states(n, seed, hi, K)
    rng = np.random.default_rng(seed + stage)
    passes = 0
    for t0, t1 in _cuts(rng, 0, n - 2):
        st = port_state(states[t0][1])
        S = _model_state(st)
        before = int(S["stats"][0])
        _segment_model(S, t0, t1, n, K, rng, stage=stage)
        segment.dnj_segment_plain(*(st[k] for k in KEYS), t0, t1, n, K)
        _assert_state(S, _numpy(st), f"after [{t0}, {t1})")
        passes += int(S["stats"][0]) - before
    assert K > 8 or passes > n - 2  # some join took several passes


def _random_state(rng, n=512):
    """A state no run reaches: random symmetric cells in [0, 6), row
    sums and cached Q in the range of the repair's values (so that both
    column updates often hit one row and the scan writes back stale
    rows), a random seed; m and the first join t0 such that the segment
    ends at most a few joins before m_t == 3."""
    Dm = np.triu(rng.integers(0, 6, (n, n), dtype=np.uint8), 1)
    Dm = Dm + Dm.T
    m = int(rng.integers(8, n + 1))
    t0 = max(0, m - 2 - int(rng.integers(4, 24)))
    span = 12 * m
    st = {"words": torch.from_numpy(Dm.copy()).view(torch.int32)}
    for key in ("sD2", "I", "J", "DIJ2", "SDI2", "SDJ2"):
        st[key] = torch.from_numpy(
            rng.integers(0, span, n).astype(np.int32))
    # a cached column below its row, as the scan's picks need
    st["P"] = torch.from_numpy((rng.random(n) * np.arange(n))
                               .astype(np.int32))
    st["Q"] = torch.from_numpy(
        rng.integers(-3 * span, 2 * span, n).astype(np.int32))
    st["seed"] = torch.tensor([int(rng.integers(0, m - t0))])
    st["stats"] = torch.from_numpy(rng.integers(0, 99, 4).astype(np.int32))
    return st, t0, m - 2 - int(rng.integers(0, 3)), m


@pytest.mark.parametrize("G", [1, 2, 3, 5, 128])
def test_dnj_segment_kernel_model_matches_plain_on_random_states(G):
    """The same on random states, where the scan takes several passes
    and the order of the column-j and column-i updates of a row's Q
    decides the result far more often than in a real run."""
    rng = np.random.default_rng(200 + G)
    for case in range(6):
        st, t0, t1, m = _random_state(rng)
        S = _model_state(st)
        _segment_model(S, t0, t1, m, G, rng)
        segment.dnj_segment_plain(*(st[k] for k in KEYS), t0, t1, m, G)
        _assert_state(S, _numpy(st), f"case {case}, [{t0}, {t1}), m {m}")


@pytest.mark.parametrize("fault", ["drop pass", "drop A", "drop B",
                                   "early copy"])
def test_dnj_segment_kernel_model_sees_a_missing_barrier(fault):
    """Without one of the kernel's grid barriers, or with Q copied for
    the next join before the body's second barrier, the model differs
    from the plain loop (or its blocks reach different barriers, where
    the card would hang) on at least one of a few seeded states."""
    kw = ({"early_copy": True} if fault == "early copy"
          else {"drop": fault.split()[1]})
    rng = np.random.default_rng(7)
    for case in range(8):
        st, t0, t1, m = _random_state(rng)
        S = _model_state(st)
        try:
            _segment_model(S, t0, t1, m, 5, rng, **kw)
        except _Diverged:
            return
        segment.dnj_segment_plain(*(st[k] for k in KEYS), t0, t1, m, 5)
        ours = _numpy(st)
        if any(not np.array_equal(np.asarray(S[k]).reshape(-1),
                                  np.asarray(ours[k]).reshape(-1))
               for k in KEYS):
            return
    pytest.fail(f"the model with {fault} matched the plain loop on every "
                "state")


# ---------------------------------------------------------------------
# the wrapper


def _args(n=512):
    v = {k: torch.zeros(n, dtype=torch.int32) for k in
         ("sD2", "Q", "P", "I", "J", "DIJ2", "SDI2", "SDJ2")}
    return dict(words=torch.zeros((n, n // 4), dtype=torch.int32),
                seed=torch.zeros(1, dtype=torch.int64),
                stats=torch.zeros(4, dtype=torch.int32), **v)


@pytest.mark.parametrize("bad,match", [
    (dict(Q=torch.zeros(512, dtype=torch.int64)), "Q: expected"),
    (dict(words=torch.zeros((512, 256), dtype=torch.int32)[:, ::2]),
     "words: expected"),
    (dict(SDJ2=torch.zeros(511, dtype=torch.int32)), "bad shapes"),
    (dict(words=torch.zeros((512, 64), dtype=torch.int32)), "bad shapes"),
    (dict(stats=torch.zeros(3, dtype=torch.int32)), "bad shapes"),
    (dict(seed=torch.zeros(1, dtype=torch.int32)), "seed: expected"),
    (dict(words=torch.zeros((576, 144), dtype=torch.int32),
          **{k: torch.zeros(576, dtype=torch.int32) for k in
             ("sD2", "Q", "P", "I", "J", "DIJ2", "SDI2", "SDJ2")}),
     "n % 128"),
    (dict(Q=torch.zeros(513, dtype=torch.int32)[1:]), "aligned"),
    (dict(K=0), "K = 0"),
    (dict(K=133), "K = 133"),
    (dict(max_blocks=-2), "K = 128"),
])
def test_dnj_segment_wrapper_checks_cuda_arguments(bad, match):
    """The checks of the CUDA route (run once a run, by
    `dnj_segment_prepare`, before the kernel's scratch is allocated)
    refuse what the kernel does not take; on the CPU the wrapper runs
    the plain version and never reaches them."""
    a = _args()
    lim = dict(K=128, max_blocks=132)
    for k, v in bad.items():
        (lim if k in lim else a)[k] = v
    with pytest.raises(ValueError, match=match):
        segment.check_segment_args(*(a[k] for k in KEYS), **lim)
    segment.check_segment_args(*(_args()[k] for k in KEYS), K=132,
                               max_blocks=132)


@pytest.mark.parametrize("t0,t1,m", [(-1, 5, 40), (6, 5, 40), (0, 39, 40),
                                     (0, 5, 513)])
def test_dnj_segment_wrapper_checks_the_joins(t0, t1, m):
    """Every join of a launch has at least 3 active rows, within n."""
    with pytest.raises(ValueError, match="need 0 <= t0"):
        segment.check_segment_range(t0, t1, m, 512)
    segment.check_segment_range(0, 38, 40, 512)
    segment.check_segment_range(38, 38, 40, 512)


def test_flags_drop_the_copy_of_q_where_it_does_not_fit():
    """Q in shared memory takes 4 bytes a row: the copy is dropped above
    57,824 rows, the other flags kept."""
    assert segment.segment_flags(32768) == segment.FLAGS
    big = segment.segment_flags(65536)
    assert big == segment.FLAGS & ~segment.STAGE_Q
    assert segment.smem_bytes(segment.FLAGS, 32768) \
        <= segment.MAX_DYNAMIC_SMEM < segment.smem_bytes(segment.FLAGS,
                                                         65536)


@pytest.mark.parametrize("n,stage", [(20480, True), (57344, True),
                                     (57824, True), (57825, False),
                                     (57856, False), (100352, False)])
def test_stage_q_limit(n, stage):
    """STAGE_Q holds up to (227 * 1024 - 1024 - 128) / 4 = 57,824 rows:
    the parity run's 20,480 padded rows keep it, its 100,352 drop it
    (the largest padded size with it is 57,344), PROFILE either way."""
    for extra in (0, segment.PROFILE):
        flags = segment.segment_flags(n, segment.STAGE_Q | extra)
        assert bool(flags & segment.STAGE_Q) == stage
        assert flags & segment.PROFILE == extra
