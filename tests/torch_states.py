"""States of a run of the JAX packed engine, for the tests of the port's
batch scan and join body (tests/test_torch_scan.py,
tests/test_torch_join.py)."""

import functools
import os

import numpy as np

import jax.numpy as jnp

import ccphylo_tpu.tree.packed_engine as jpe
import ccphylo_tpu_torch.tree.packed_engine as tpe
from ccphylo_tpu_torch.interop import state_from_jax


@functools.lru_cache(maxsize=8)
def jax_states(n, seed, hi, K):
    """States of the JAX packed engine before every join of one run on
    random integer cells in [0, hi): [(joins done, {key: numpy array})],
    the last one the final state.  Cached: callers must not write into
    the arrays (`port_state` copies them)."""
    rng = np.random.RandomState(seed)
    qv = rng.randint(0, hi, n * (n - 1) // 2).astype(np.uint8)
    Dq = np.zeros((tpe.pad_packed(n),) * 2, np.uint8)
    iu = np.tril_indices(n, -1)
    Dq[(iu[0], iu[1])] = qv
    Dq[(iu[1], iu[0])] = qv
    words = jpe.pack_words(Dq)
    npad = words.shape[0]
    sD2, Q, P, sd = jpe._packed_init(words, jnp.int32(n))
    z = np.zeros(npad, np.int32)
    states = [(0, dict(zip(jpe._STATE_KEYS, (
        np.asarray(words), np.asarray(sD2), np.asarray(Q), np.asarray(P),
        np.asarray(sd), z, z, z, z, z, np.zeros(4, np.int32)))))]

    def snap(state, done, total):
        states.append((done, {k: np.array(v) for k, v in
                              zip(jpe._STATE_KEYS, state)}))

    # one join per segment, so the hook sees every state
    env = {"CCPHYLO_TPU_SEG": "1", "CCPHYLO_TPU_SEG_FIXED": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        jpe.dnj_joins_packed(words, jnp.int32(n), kbatch=K, hooks=snap)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert [d for d, _ in states] == list(range(n - 1))
    return states


def port_state(d):
    """The port's engine state on copies of the arrays of `d` (the port
    updates its state in place)."""
    return state_from_jax(engine_state={k: np.array(v) for k, v in
                                        d.items()})["engine_state"]
