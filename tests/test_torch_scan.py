"""The port's batch scan (ccphylo_tpu_torch/ops/scan.py, plain versions on
the CPU).  Row minima against the Pallas kernel
ops/scan_pallas.qrow_mins run in interpret mode, in the cases of
tests/test_scan_pallas.py; topk_mask_indices against ops/select.py; the
whole scan of a join, `dnj_scan_plain`, on states taken from a run of
the JAX engine, against that engine's next state; and a numpy model of
the algorithm of csrc/dnj_scan.cu (the CUDA kernel cannot run here)
against `dnj_scan_plain` on the same states.  Everything is an integer:
tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccphylo_tpu_torch.tree.packed_engine as tpe
from ccphylo_tpu.ops import select as jselect
from ccphylo_tpu.ops.scan_pallas import qrow_mins as pallas_qrow_mins
from ccphylo_tpu_torch.ops import scan, select

from .torch_states import jax_states, port_state

IBIG = 2 ** 31 - 1

# Small shapes: one intra-op thread.  The JAX CPU backend's worker
# threads share the cores in this process, and torch's OpenMP pool
# then stalls on every small op of the engine loop.
torch.set_num_threads(1)


def _both(rows, co, words, sd2):
    rmin, rarg = scan.qrow_mins(
        torch.from_numpy(np.asarray(rows, np.int32)), co,
        torch.from_numpy(np.ascontiguousarray(words).view(np.int32)),
        torch.from_numpy(np.asarray(sd2, np.int32)))
    pmin, parg = pallas_qrow_mins(
        jnp.asarray(rows, jnp.int32), jnp.int32(co), jnp.asarray(words),
        jnp.asarray(sd2, jnp.int32), interpret=True)
    return rmin.numpy(), rarg.numpy(), np.asarray(pmin), np.asarray(parg)


def _case(name):
    rng = np.random.default_rng({"random": 7, "padding": 11,
                                 "repeated": 13}.get(name, 0))
    n = 512
    W = n // 4
    co = 2 * (n - 2)
    if name == "ties":
        words = np.full((n, W), 0x05050505, np.uint32)  # all cells = 5
        sd2 = np.zeros(n, np.int32)
        rows = np.asarray([1, 2, 3, 100, 255, 256, 511, 8], np.int32)
        return rows, 10, words, sd2
    words = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    sd2 = rng.integers(0, 1 << (20 if name == "random" else 16), n,
                       dtype=np.int32)
    rows = {"random": rng.integers(1, n, 16, dtype=np.int32),
            "padding": np.asarray([0, 37, 0, 511, 0, 256, 2, 0], np.int32),
            "repeated": np.asarray([300, 300, 300, 7, 7, 511, 511, 1],
                                   np.int32)}[name]
    return rows, co, words, sd2


@pytest.mark.parametrize("name", ["random", "ties", "padding", "repeated"])
def test_qrow_mins_matches_pallas(name):
    rows, co, words, sd2 = _case(name)
    rmin, rarg, pmin, parg = _both(rows, co, words, sd2)
    # every lane, padding rows included: both give (IBIG, n - 1) there
    np.testing.assert_array_equal(rmin, pmin)
    np.testing.assert_array_equal(rarg, parg)
    if name == "ties":
        np.testing.assert_array_equal(rarg, rows - 1)  # last wins
        np.testing.assert_array_equal(rmin, np.full(len(rows), 50))
    if name == "padding":
        assert (rmin[rows == 0] == IBIG).all()
        assert (rarg[rows == 0] == len(words) - 1).all()


@pytest.mark.parametrize("seed,n,K,p", [(0, 300, 16, 0.1), (1, 300, 128, 0.5),
                                        (2, 64, 128, 0.9), (3, 50, 8, 0.0)])
def test_topk_mask_indices_matches_jax(seed, n, K, p):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < p
    idx = np.arange(n, dtype=np.int32)
    ours = select.topk_mask_indices(torch.from_numpy(mask),
                                    torch.from_numpy(idx), K)
    ref = jselect.topk_mask_indices(jnp.asarray(mask), jnp.asarray(idx), K)
    assert ours.dtype == torch.int32 and ours.shape == (K,)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------
# the whole scan of a join


@pytest.mark.parametrize("n,seed,hi,K", [(90, 3, 200, 128), (90, 4, 6, 8),
                                         (130, 5, 40, 4)])
def test_dnj_scan_plain_steps_match_jax_engine(n, seed, hi, K):
    """One join of the port from each state of a JAX run — the plain
    scan, then the join body — gives the JAX engine's next state: the
    pair (i, j), Q, P, sD2, the byte matrix, the seed and the stats."""
    states = jax_states(n, seed, hi, K)
    passes = 0
    for (t, before), (_, after) in zip(states[:-1], states[1:]):
        st = port_state(before)
        tpe._one_join(st, t, n, K, scan.dnj_scan_plain, tpe.dnj_join_plain)
        assert (st["I"][t], st["J"][t]) == (after["I"][t], after["J"][t])
        for key in ("Q", "P", "sD2", "stats", "DIJ2", "SDI2", "SDJ2"):
            np.testing.assert_array_equal(st[key].numpy(), after[key],
                                          err_msg=f"{key} after join {t}")
        np.testing.assert_array_equal(
            st["words"].numpy().view(np.uint32), after["words"])
        assert int(st["seed"]) == int(after["seed"])
        passes = int(after["stats"][0])
    if K < 128:
        assert passes > n - 2  # some join took several passes


def _wrap32(x):
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31) \
        .astype(np.int64)


def _select_model(Q, hi, minv, k, warps=8):
    """Row of rank k (descending) among the candidates below `hi`, and
    their total, by the stripes, groups and lanes of dnj_scan.cu's
    selection step."""
    def cand(i):
        return 1 <= i < hi and Q[i] < minv

    G = (hi + 127) // 128
    gpw = -(-G // warps)
    stripes = []
    for w in range(warps):
        gtop = G - 1 - w * gpw
        stripes.append(range(gtop, max(gtop - gpw + 1, 0) - 1, -1))
    cnt = [sum(cand(128 * g + e) for g in st for e in range(128))
           for st in stripes]
    total = sum(cnt)
    if k >= total:
        return 0, total
    above = 0
    for w in range(warps):
        if above <= k < above + cnt[w]:
            break
        above += cnt[w]
    seen = above
    for g in stripes[w]:
        p = [[cand(128 * g + 4 * lane + e) for e in range(4)]
             for lane in range(32)]
        gt = sum(map(sum, p))
        if seen + gt <= k:
            seen += gt
            continue
        for lane in range(32):
            rank = seen + sum(map(sum, p[lane + 1:]))
            for e in (3, 2, 1, 0):
                if p[lane][e]:
                    if rank == k:
                        return 128 * g + 4 * lane + e, total
                    rank += 1
    raise AssertionError("rank not found")


def _kernel_model(D8, sD2, Q, P, seed, m_t, co, K):
    """The algorithm of csrc/dnj_scan.cu on numpy arrays, Q and P in
    place: each pass walks only below the last selected row of the pass
    before, ends when a pass found at most K candidates, and counts the
    changed rows where it writes them.  Returns (pi, pj, passes,
    changed)."""
    n = len(Q)
    minv, pi, pj = IBIG, 0, 0
    if seed != 0 and Q[seed] != IBIG:
        minv, pi, pj = int(Q[seed]), seed, int(P[seed])
    hi, npass, nchanged = m_t, 0, 0
    while True:
        rows, total = [], None
        for k in range(K):  # one block each
            r, total = _select_model(Q, hi, minv, k)
            rows.append(r if k < total else -1)
        if total == 0:
            break
        trip = []
        for r in rows:
            if r < 0:
                trip.append((IBIG, -1))
                continue
            q = _wrap32(co * D8[r, :r].astype(np.int64) - sD2[r] - sD2[:r])
            rmin = int(q.min())
            rarg = int(np.flatnonzero(q == rmin).max())
            trip.append((rmin, n - 1 if rmin == IBIG else rarg))
        # after the grid barrier: block k gates and writes its own row
        for k, r in enumerate(rows):
            if r < 0:
                continue
            before = min([minv] + [v for v, _ in trip[:k]])
            if Q[r] < before:
                nchanged += int(trip[k][0] != Q[r])
                Q[r], P[r] = trip[k]
        bv, br, ba = IBIG, -1, 0
        for (v, a), r in zip(trip, rows):
            if v < bv or (v == bv and r > br):
                bv, br, ba = v, r, a
        if bv < minv:
            minv, pi, pj = bv, br, ba
        npass += 1
        if total <= K:
            break
        hi = rows[K - 1]
    return pi, pj, npass, nchanged


@pytest.mark.parametrize("n,seed,hi,K", [(70, 3, 200, 128), (70, 4, 6, 8),
                                         (200, 5, 40, 4), (300, 6, 3, 2)])
def test_dnj_scan_kernel_algorithm_matches_plain(n, seed, hi, K):
    """The kernel's shortcuts (bounded walks, early end, changed rows
    counted at the write) give dnj_scan_plain's result, Q and P on
    every state of a run, stale caches and ties included."""
    states = jax_states(n, seed, hi, K)
    several = 0
    for t, d in states[:-1]:
        st = port_state(d)
        m_t = n - t
        co = 2 * (m_t - 2)
        Q, P = d["Q"].astype(np.int64), d["P"].astype(np.int64)
        D8 = d["words"].view(np.uint8)
        model = _kernel_model(D8, d["sD2"].astype(np.int64), Q, P,
                              int(d["seed"]), m_t, co, K)
        res = scan.dnj_scan_plain(st["words"], st["sD2"], st["Q"], st["P"],
                                  st["seed"], m_t, co, K)
        assert tuple(res.tolist()) == model, f"join {t}"
        np.testing.assert_array_equal(st["Q"].numpy(), Q)
        np.testing.assert_array_equal(st["P"].numpy(), P)
        several += model[2] > 1
    assert K == 128 or several > 0  # the bounded second walk was taken


def test_dnj_scan_wrapper_checks_cuda_arguments():
    """On the CPU the wrapper takes the plain version; the checks of the
    CUDA route are reached only by a CUDA tensor."""
    n = 512
    words = torch.zeros((n, n // 4), dtype=torch.int32)
    v = torch.zeros(n, dtype=torch.int32)
    res = scan.dnj_scan(words, v.clone(), v.clone() + IBIG, v.clone(),
                        torch.zeros(1, dtype=torch.int64), 5, 6, 128)
    assert res.tolist() == [0, 0, 0, 0] and res.dtype == torch.int32
