"""The join body of the port's packed DNJ engine (ccphylo_tpu_torch/
ops/join.py, plain versions on the CPU).  From every state of a run of
the JAX packed engine, the port's plain scan followed by
`dnj_join_plain` gives the JAX engine's next state; a numpy model of the
phases of csrc/dnj_join.cu (the CUDA kernel cannot run here), with its
block partition, its barriers and its threads run in a random order
within each phase, gives `dnj_join_plain`'s result on the same states;
the wrapper's argument checks refuse what the kernel does not take.
Everything is an integer: tolerance 0.  Every run has m < npad (rows
padded to 512), so the padding bytes are compared too."""

import numpy as np
import pytest
import torch

from ccphylo_tpu_torch.ops import join, scan

from .torch_states import jax_states, port_state

IBIG = 2 ** 31 - 1
KEYS = ("words", "sD2", "Q", "P", "seed", "I", "J", "DIJ2", "SDI2", "SDJ2",
        "stats")
THREADS = 256  # threads of a block of dnj_join_kernel

# Small shapes: one intra-op thread.  The JAX CPU backend's worker
# threads share the cores in this process, and torch's OpenMP pool
# then stalls on every small op of the engine loop.
torch.set_num_threads(1)


def _scanned(d, t, n, K):
    """The port's state of `d` after the plain scan of join t, and the
    scan's result."""
    st = port_state(d)
    m_t = n - t
    res = scan.dnj_scan_plain(st["words"], st["sD2"], st["Q"], st["P"],
                              st["seed"], m_t, 2 * (m_t - 2), K)
    return st, res


def _numpy(st):
    out = {k: st[k].numpy().copy() for k in KEYS}
    out["words"] = out["words"].view(np.uint32)
    return out


@pytest.mark.parametrize("n,seed,hi,K", [(70, 3, 3, 4), (200, 5, 6, 128),
                                         (300, 6, 40, 4), (200, 7, 200, 128),
                                         (70, 8, 200, 4)])
def test_dnj_join_plain_steps_match_jax_engine(n, seed, hi, K):
    """Scan then `dnj_join_plain` from each state of a JAX run gives the
    JAX engine's next state, every array of it; the run met a popArrange
    from the last row (i == last), neighbouring rows (i == j + 1) and
    the last join (m_t == 3)."""
    states = jax_states(n, seed, hi, K)
    met = {"i == last": 0, "i == j + 1": 0, "m_t == 3": 0, "pop": 0}
    for (t, before), (_, after) in zip(states[:-1], states[1:]):
        st, res = _scanned(before, t, n, K)
        join.dnj_join_plain(*(st[k] for k in KEYS), res, t, n - t)
        ours = _numpy(st)
        for k in KEYS:
            np.testing.assert_array_equal(ours[k].reshape(-1),
                                          np.asarray(after[k]).reshape(-1),
                                          err_msg=f"{k} after join {t}")
        i, j, m_t = int(after["I"][t]), int(after["J"][t]), n - t
        met["i == last"] += i == m_t - 1
        met["i == j + 1"] += i == j + 1
        met["m_t == 3"] += m_t == 3
        met["pop"] += i != m_t - 1
    assert all(met.values()), met


# ---------------------------------------------------------------------
# a model of the kernel's phases


def _wrap(x):
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _take(best, cand):
    """The better (value, index): smaller value, then larger index."""
    (v, x), (ov, ox) = best, cand
    return cand if ov < v or (ov == v and ox > x) else best


def _run(tasks, rng):
    for k in rng.permutation(len(tasks)):
        tasks[k]()


def _join_model(S, out, t, m_t, B, rng):
    """csrc/dnj_join.cu on the numpy state S, in place: B blocks of
    THREADS threads, thread g owning k = g, g + B*THREADS, ...; within a
    phase the threads (and the work of block 0's thread 0 apart) run one
    after another in a random order; block partials are reduced after
    the grid barrier."""
    D = S["words"].view(np.uint8)
    sd2, Q, P = S["sD2"], S["Q"], S["P"]
    n = D.shape[0]
    T = B * THREADS
    threads = range(min(T, n))
    i, j = int(out[0]), int(out[1])
    last = m_t - 1

    def lead_a():
        S["I"][t], S["J"][t] = i, j
        if i or j:
            S["DIJ2"][t] = 2 * int(D[i, j])
            S["SDI2"][t], S["SDJ2"][t] = sd2[i], sd2[j]
        else:
            S["DIJ2"][t] = S["SDI2"][t] = S["SDJ2"][t] = 0
        S["stats"][:2] += out[2:4]

    if i == 0 and j == 0:
        lead_a()
        Q[last] = IBIG
        S["seed"][...] = 0
        return
    cij = int(D[i, j])
    sums = [0] * B

    def thread_a(g):
        for k in range(g, m_t, T):
            if k in (i, j):
                continue
            ci, cj = int(D[i, k]), int(D[j, k])
            d = max(ci + cj - cij, 0)
            sd2[k] -= 2 * ci + 2 * cj - d
            sums[g // THREADS] += d
            D[j, k] = D[k, j] = min((2 * d + 1) >> 2, 255)

    _run([lead_a] + [lambda g=g: thread_a(g) for g in threads], rng)
    # grid barrier
    sdj = sum(sums)
    pop = i != last
    co_post = 2 * (m_t - 3)
    red = [[(IBIG, -1)] * B for _ in range(4)]  # row j, col j, row i, col i

    def lead_b():
        sdl = int(sd2[last])
        sd2[j] = sdj
        if pop:
            sd2[i] = sdl

    def thread_b(g):
        sdl = int(sd2[last])
        blk = g // THREADS
        for k in range(g, n, T):
            sk = sdj if k == j else (int(sd2[k]) if k < m_t and k != i
                                     else 0)
            qk = None
            if k < j or (j < k < m_t and k != i):
                q = _wrap(co_post * int(D[j, k]) - sdj - sk)
                if k < j:
                    red[0][blk] = _take(red[0][blk], (q, k))
                else:
                    qk = int(Q[k])
                    if q <= qk:
                        Q[k] = qk = q
                        P[k] = j
                        red[1][blk] = _take(red[1][blk], (q, k))
            if pop:
                v = 0 if k == i else int(D[last, k])
                D[i, k] = D[k, i] = v
                q = _wrap(co_post * v - sdl - sk)
                if k < i:
                    red[2][blk] = _take(red[2][blk], (q, k))
                elif i < k < last:
                    if q <= qk:
                        Q[k] = q
                        P[k] = i
                        red[3][blk] = _take(red[3][blk], (q, k))

    _run([lead_b] + [lambda g=g: thread_b(g) for g in threads], rng)
    # grid barrier; block 0 alone
    best = []
    for r in range(4):
        b = (IBIG, -1)
        for bb in rng.permutation(B):
            b = _take(b, red[r][bb])
        best.append(b)
    Qj = best[0][0]
    Q[j], P[j] = Qj, 0 if Qj == IBIG else best[0][1]
    mi = best[1][1] if best[1][1] >= 0 and best[1][0] <= Qj else j
    mj = 0
    if pop:
        Qi = best[2][0]
        Q[i], P[i] = Qi, 0 if Qi == IBIG else best[2][1]
        mj = best[3][1] if best[3][1] >= 0 and best[3][0] <= Qi else i
    Q[last] = IBIG
    qmj, qmi = int(Q[mj]), int(Q[mi])
    if mj == last:
        s = mi
    elif mi == last:
        s = mj
    else:
        s = mj if qmj < qmi or (mi < mj and qmj == qmi) else mi
    S["seed"][...] = s


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("n,seed,hi,K", [(70, 3, 3, 4), (200, 5, 6, 128)])
def test_dnj_join_kernel_phases_match_plain(n, seed, hi, K, B):
    """The kernel's decomposition (owned indices, per-block partials, the
    two grid barriers, block 0's last phase) gives `dnj_join_plain`'s
    state on every join of a run, whatever order the threads of a phase
    run in."""
    rng = np.random.default_rng(B)
    states = jax_states(n, seed, hi, K)
    for t, d in states[:-1]:
        st, res = _scanned(d, t, n, K)
        S = _numpy(st)
        S["words"] = S["words"].copy()
        _join_model(S, res.numpy(), t, n - t, B, rng)
        join.dnj_join_plain(*(st[k] for k in KEYS), res, t, n - t)
        ours = _numpy(st)
        for k in KEYS:
            np.testing.assert_array_equal(S[k], ours[k],
                                          err_msg=f"{k} after join {t}")


def _random_state(rng, n=512):
    """A state no run reaches, for the phases alone: random symmetric
    cells in [0, 6), row sums and cached Q in the range of the repair's
    values (so both column updates often hit one row and their order
    decides), a random pair and m_t, edges included."""
    D = np.triu(rng.integers(0, 6, (n, n), dtype=np.uint8), 1)
    D = D + D.T
    m_t = int(rng.choice([3, 4, 5, rng.integers(6, n + 1), n]))
    i = int(rng.choice([m_t - 1, rng.integers(1, m_t)]))
    j = int(rng.choice([i - 1, rng.integers(0, i)]))
    if rng.random() < 0.1:
        i = j = 0
    st = {"words": torch.from_numpy(D.copy()).view(torch.int32)}
    span = 12 * m_t
    for k in ("sD2", "P", "I", "J", "DIJ2", "SDI2", "SDJ2"):
        st[k] = torch.from_numpy(rng.integers(0, span, n).astype(np.int32))
    st["Q"] = torch.from_numpy(
        rng.integers(-3 * span, 2 * span, n).astype(np.int32))
    st["seed"] = torch.tensor([int(rng.integers(0, m_t))])
    st["stats"] = torch.from_numpy(rng.integers(0, 99, 4).astype(np.int32))
    out = torch.tensor([i, j, 2, 5], dtype=torch.int32)
    return st, out, int(rng.integers(0, n - m_t + 1)), m_t


@pytest.mark.parametrize("B", [1, 3, 128])
def test_dnj_join_kernel_phases_match_plain_on_random_states(B):
    """The same on random states, where the order of the column-j and
    column-i updates of a row's Q, and of the writes of rows j and i,
    decides the result far more often than in a real run."""
    rng = np.random.default_rng(100 + B)
    for case in range(40):
        st, out, t, m_t = _random_state(rng)
        S = _numpy(st)
        S["words"] = S["words"].copy()
        _join_model(S, out.numpy(), t, m_t, B, rng)
        join.dnj_join_plain(*(st[k] for k in KEYS), out, t, m_t)
        ours = _numpy(st)
        for k in KEYS:
            np.testing.assert_array_equal(S[k], ours[k],
                                          err_msg=f"{k}, case {case}")


def test_no_joinable_pair():
    """A scan that found no pair (i == j == 0): zero records, the scan's
    counts added, Q[last] closed, seed 0, nothing else touched."""
    n = 512
    words = torch.arange(n * n // 4, dtype=torch.int32).view(n, n // 4)
    st = {k: torch.arange(n, dtype=torch.int32) + 7 for k in
          ("sD2", "Q", "P", "I", "J", "DIJ2", "SDI2", "SDJ2")}
    st.update(words=words.clone(), seed=torch.tensor([5]),
              stats=torch.tensor([1, 2, 3, 4], dtype=torch.int32))
    before = {k: v.clone() for k, v in st.items()}
    out = torch.tensor([0, 0, 3, 9], dtype=torch.int32)
    t, m_t = 10, 40
    join.dnj_join(*(st[k] for k in KEYS), out, t, m_t)
    for k in ("I", "J", "DIJ2", "SDI2", "SDJ2"):
        assert int(st[k][t]) == 0
        before[k][t] = 0
    before["Q"][m_t - 1] = IBIG
    before["stats"][:2] += out[2:]
    before["seed"][0] = 0
    for k in KEYS:
        assert torch.equal(st[k], before[k]), k


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
    (dict(blocks=0), "blocks = 0"),
    (dict(blocks=265), "blocks = 265"),
    (dict(max_blocks=-2), "blocks = 1"),
])
def test_dnj_join_wrapper_checks_cuda_arguments(bad, match):
    """The checks of the CUDA route (run once a run, by
    `dnj_join_prepare`, before the kernel's scratch is allocated) refuse
    what the kernel does not take; on the CPU the wrapper runs the plain
    version and never reaches them."""
    a = _args()
    lim = dict(blocks=1, max_blocks=264)
    for k, v in bad.items():
        (lim if k in lim else a)[k] = v
    with pytest.raises(ValueError, match=match):
        join.check_join_args(*(a[k] for k in KEYS), **lim)
    join.check_join_args(*(_args()[k] for k in KEYS), blocks=264,
                         max_blocks=264)
