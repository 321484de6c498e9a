"""The port's batch scan (ccphylo_tpu_torch/ops/scan.py, plain versions on
the CPU).  Row minima against the Pallas kernel
ops/scan_pallas.qrow_mins run in interpret mode, in the cases of
tests/test_scan_pallas.py; topk_mask_indices against ops/select.py; and
the whole scan of a join, `dnj_scan_plain` followed by the join body,
on states taken from a run of the JAX engine, against that engine's
next state.  Everything is an integer: tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccphylo_tpu_torch.tree.packed_engine as tpe
from ccphylo_tpu.ops import select as jselect
from ccphylo_tpu.ops.scan_pallas import qrow_mins as pallas_qrow_mins
from ccphylo_tpu_torch.ops import join, scan, select

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
                                         (130, 5, 40, 4), (300, 6, 3, 2),
                                         (70, 3, 200, 128)])
def test_dnj_scan_plain_steps_match_jax_engine(n, seed, hi, K):
    """One join of the port from each state of a JAX run — the plain
    scan, then the join body — gives the JAX engine's next state: the
    pair (i, j), Q, P, sD2, the byte matrix, the seed and the stats."""
    states = jax_states(n, seed, hi, K)
    passes = 0
    for (t, before), (_, after) in zip(states[:-1], states[1:]):
        st = port_state(before)
        m_t = n - t
        res = scan.dnj_scan_plain(st["words"], st["sD2"], st["Q"], st["P"],
                                  st["seed"], m_t, 2 * (m_t - 2), K)
        join.dnj_join_plain(*(st[k] for k in tpe._STATE_KEYS), res, t, m_t)
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
