"""The join body of the port's packed DNJ engine (ccphylo_tpu_torch/
ops/join.py).  From every state of a run of the JAX packed engine, the
port's plain scan followed by `dnj_join_plain` gives the JAX engine's
next state; a scan that found no pair leaves all but the records, the
counts, Q[last] and the seed untouched.  The kernel that runs this body
on the card, csrc/dnj_segment.cu, has its numpy model in
tests/test_torch_segment.py.  Everything is an integer: tolerance 0.
Every run has m < npad (rows padded to 512), so the padding bytes are
compared too."""

import numpy as np
import pytest
import torch

from ccphylo_tpu_torch.ops import join, scan

from .torch_states import jax_states, port_state

IBIG = 2 ** 31 - 1
KEYS = ("words", "sD2", "Q", "P", "seed", "I", "J", "DIJ2", "SDI2", "SDJ2",
        "stats")

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
    join.dnj_join_plain(*(st[k] for k in KEYS), out, t, m_t)
    for k in ("I", "J", "DIJ2", "SDI2", "SDJ2"):
        assert int(st[k][t]) == 0
        before[k][t] = 0
    before["Q"][m_t - 1] = IBIG
    before["stats"][:2] += out[2:]
    before["seed"][0] = 0
    for k in KEYS:
        assert torch.equal(st[k], before[k]), k
