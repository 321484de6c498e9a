"""The port's device engines of the heuristic/UPGMA family
(ccphylo_tpu_torch/tree/hclust_engine.py, on CPU tensors) against the
JAX engines of ccphylo_tpu.tree.hclust_engine (CPU backend, x64 on) and
against the host exact engine of both packages, for upgma, ff, cf, hnj,
nj and mn.

Tolerance 0 on integer matrices (wide range, tie-dense, negative
limbs): join records I, J equal, limbs and the last distance bit-equal,
Newick bytes equal.  With missing cells a one-sided update stores
non-dyadic values, so the limbs are held to 1e-12 relative against the
JAX engine (whose cumsum does not add left to right on the CPU) and the
bytes, at 9 digits, against the host engine.  What was found on a
non-integer float64 matrix is in `test_non_integer_float64`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccphylo_tpu.tree.hclust_engine as jh
import ccphylo_tpu_torch.tree.hclust_engine as th
from ccphylo_tpu.tree.exact import build_tree
from ccphylo_tpu_torch.interop import state_from_jax
from ccphylo_tpu_torch.io.qseqs import Name as PortName
from ccphylo_tpu_torch.tree.exact import build_tree as port_build_tree
from ccphylo_tpu_torch.tree.torch_engine import square_matrix

from .test_torch_engine import (STATE, _active_state_equal, _zero_records,
                                assert_records_equal, int_matrix, names,
                                padded)

# one intra-op thread beside JAX's CPU backend (see test_torch_engine)
torch.set_num_threads(1)

METHODS = ["upgma", "ff", "cf", "hnj", "nj", "mn"]


def run_both(flat, n, method, neg_limbs=False):
    ours = th.hclust_joins(torch.from_numpy(square_matrix(flat, n)), n,
                           method=method, neg_limbs=neg_limbs)
    ref = jh.hclust_joins(jnp.asarray(padded(flat, n)), jnp.int32(n),
                          method=method, neg_limbs=neg_limbs)
    return ours, ref


def assert_newick_equals_host(flat, n, method, flag=0):
    ours = th.build_tree_hclust(flat.copy(), n, names(n, PortName),
                                method=method, flag=flag,
                                dtype=torch.float64, device="cpu")
    assert ours == build_tree(flat.copy(), n, names(n), method, flag)
    assert ours == port_build_tree(flat.copy(), n, names(n, PortName),
                                   method, flag)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,seed,hi", [(5, 5, 500), (33, 33, 500),
                                       (100, 11, 10_000),
                                       (97, 7, 25)])  # last: tie-dense
def test_integer_matrix_matches_jax_and_host(method, n, seed, hi):
    flat = int_matrix(n, seed, 0, hi)
    ours, ref = run_both(flat, n, method)
    assert_records_equal(ours, ref, n - 2)
    assert_newick_equals_host(flat, n, method)


@pytest.mark.parametrize("method", METHODS)
def test_integer_matrix_n183(method, n=183):
    flat = int_matrix(n, n)
    ours, ref = run_both(flat, n, method)
    assert_records_equal(ours, ref, n - 2)
    assert_newick_equals_host(flat, n, method)


@pytest.mark.parametrize("method", ["upgma", "hnj", "nj"])
def test_negative_limbs_flag(method, n=80):
    flat = int_matrix(n, 3, 0, 60)
    ours, ref = run_both(flat, n, method, neg_limbs=True)
    assert_records_equal(ours, ref, n - 2)
    assert_newick_equals_host(flat, n, method, flag=2)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("drop", [0.02, 0.12])
def test_missing_cells(method, drop, n=64):
    """Sparse -1 (missing) cells: one-sided fallbacks, the non-advancing
    sD/N walker targets (both-missing cells), the out-of-row garbage
    read of nj.c:1022, and the FF row rebuild's no-validity-check quirk.
    The 12% rate makes both-missing pairs and column-part only_j cells
    frequent; nj and mn stop early on it (I = J = 0 records)."""
    flat = int_matrix(n, 19, 1, 40, drop)
    ours, ref = run_both(flat, n, method)
    assert_records_equal(ours, ref, n - 2, rtol=1e-12)
    assert_newick_equals_host(flat, n, method)


@pytest.mark.parametrize("method", ["upgma", "hnj"])
def test_hclust_init_matches_jax(method, n=100):
    """_hclust_init alone, on the padded matrix with missing cells: raw
    minima (initDmin) for upgma, the initHNJ tie rule for hnj."""
    D = padded(int_matrix(n, 13, 0, 12, 0.1), n)
    ours = th._hclust_init(torch.from_numpy(D.copy()), n, method)
    ref = jh._hclust_init(jnp.asarray(D), jnp.int32(n), method=method)
    for a, b in zip(ours[:4], ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(ours[4]) == int(ref[4])


@pytest.mark.parametrize("method", ["ff", "hnj"])
def test_state_carried_over_mid_run(method, n=90, k=30, k2=70):
    """The JAX engine's state after k joins runs on in the port through
    state_from_jax(float_state=...): joins k..k2 and the state after
    them equal the JAX engine's own."""
    flat = int_matrix(n, 45, 0, 40)
    mj = jnp.int32(n)
    D = jnp.asarray(padded(flat, n))
    state = jh._h_segment(D, *jh._hclust_init(D, mj, method=method),
                          *_zero_records(D), jnp.int32(0), jnp.int32(k), mj,
                          method=method)
    st = state_from_jax(float_state={
        name: np.array(v) for name, v in zip(STATE, state)})["float_state"]
    ref = jh._h_segment(*state, jnp.int32(k), jnp.int32(k2), mj,
                        method=method)
    th._h_segment(st, k, k2, n, method=method)
    assert_records_equal([st[x] for x in ("I", "J", "LI", "LJ")], ref[6:],
                         k2)
    _active_state_equal(st, ref, n - k2)


def test_nj_state_carried_over_mid_run(n=90, k=30, k2=70):
    flat = int_matrix(n, 46, 0, 40)
    mj = jnp.int32(n)
    D = jnp.asarray(padded(flat, n))
    keys = ("D", "sD", "N", "I", "J", "LI", "LJ")
    state = jh._e_segment(D, *jh._init_sdn_only(D, mj), *_zero_records(D),
                          jnp.int32(0), jnp.int32(k), mj, method="nj")
    st = state_from_jax(float_state={
        name: np.array(v) for name, v in zip(keys, state)})["float_state"]
    assert "Q" not in st and "seed" not in st
    ref = jh._e_segment(*state, jnp.int32(k), jnp.int32(k2), mj,
                        method="nj")
    th._e_segment(st, k, k2, n, method="nj")
    assert_records_equal([st[x] for x in ("I", "J", "LI", "LJ")], ref[3:],
                         k2)
    m_t = n - k2
    for name, b in zip(keys[:3], ref):
        a = st[name].numpy()
        np.testing.assert_array_equal(a[:m_t, :m_t] if name == "D"
                                      else a[:m_t], np.asarray(b)[
            (slice(m_t), slice(m_t)) if name == "D" else slice(m_t)])


def test_unknown_method_is_refused():
    with pytest.raises(ValueError, match="upgma"):
        th.hclust_joins(torch.zeros((4, 4), dtype=torch.float64), 4,
                        method="dnj")


def _uniform_matrix(n, seed=78):
    return np.random.RandomState(seed).uniform(0.5, 90.0, n * (n - 1) // 2)


@pytest.mark.parametrize("method", ["upgma", "cf", "ff", "hnj", "nj"])
def test_non_integer_float64(method, n=150):
    """A seeded non-integer float64 matrix.  upgma and cf pick on raw
    distances: I, J equal the JAX engine's.  Found for ff, hnj and nj
    on this matrix: every pick is equal too, and for all five the
    port's Newick at 9 digits equals the host exact engine's.  The
    limbs agree with the JAX engine's within 1e-11 relative, not
    1e-12: a limb is a small difference of row sums near 1e4, the two
    packages add those in different orders, and the largest deviation
    found is 1.7e-12 (one limb of 148, for cf and nj).  That is this
    matrix on this device, not a guarantee: hnj and nj pick on sums,
    and a device that adds in another order can flip a tied pick (the
    float-scope guard of the CLI stays).  mn is
    `test_non_integer_float64_mn`."""
    flat = _uniform_matrix(n)
    ours, ref = run_both(flat, n, method)
    assert_records_equal(ours[:4], ref[:4], n - 2, rtol=1e-11)
    assert_newick_equals_host(flat, n, method)


def test_non_integer_float64_mn(n=150):
    """Found for mn, which the reference counts among the methods whose
    picks avoid sums: its pick is the largest Q = coef * d - sD_i -
    sD_j.  Joining the largest Q first drives the updated distances of
    this complete matrix to 0 within the first joins; what is left in
    the row sums is rounding noise near 1e-13, and Q compares that
    noise.  The port follows the JAX engine's picks until a join where
    the two candidate pairs tie within the noise, and there the order
    of the sums decides: not a port fault, and one more reason the
    default route keeps non-integer matrices on the host."""
    flat = _uniform_matrix(n)
    ours, ref = run_both(flat, n, "mn")
    I, J = ours[0][:n - 2], ours[1][:n - 2]
    RI, RJ = np.asarray(ref[0])[:n - 2], np.asarray(ref[1])[:n - 2]
    differ = np.nonzero((I != RI) | (J != RJ))[0]
    assert ((J < I) & (I < n - np.arange(n - 2))).all()
    if not len(differ):
        return
    t = int(differ[0])
    assert t > 0
    # the port's state before join t: Q of its pick and of the JAX pick
    D = torch.from_numpy(square_matrix(flat, n))
    sD, N = th._hclust_init(D, n, "mn")[:2]
    st = {"D": D, "sD": sD, "N": N, "idx": torch.arange(n),
          **th._records(n, D.dtype)}
    th._e_segment(st, 0, t, n, method="mn")

    def q(i, j):
        coef = (int(N[i]) + int(N[j]) - 4) >> 1
        return coef * float(D[i, j]) - float(sD[i]) - float(sD[j])

    assert abs(q(I[t], J[t]) - q(RI[t], RJ[t])) < 1e-9
    assert float(sD[:n - t].abs().max()) < 1e-9
