"""The port's device DNJ engines (ccphylo_tpu_torch/tree/torch_engine.py,
on CPU tensors) against the JAX engines of ccphylo_tpu.tree.jax_engine
(CPU backend, x64 on) and against the host exact engine of both
packages.

Tolerance 0 wherever the data keeps every sum exact: join records I, J
equal, limbs LI, LJ and the last distance bit-equal, Newick bytes
equal.  That covers integer matrices (float64 at every size here;
float32 while the sums of both packages stay within 24 bits, see
`test_float32_records_match_jax`), tie-dense and missing-data matrices,
negative limbs, and u16/u8 quantized storage.  On a non-integer
float64 matrix the picks are compared and the limbs held to 1e-12
relative; what was found there is in `test_non_integer_float64`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ccphylo_tpu.tree.jax_engine as je
import ccphylo_tpu_torch.tree.torch_engine as te
from ccphylo_tpu.io.qseqs import Name
from ccphylo_tpu.tree.exact import build_tree
from ccphylo_tpu_torch.interop import state_from_jax
from ccphylo_tpu_torch.io.qseqs import Name as PortName
from ccphylo_tpu_torch.tree.exact import build_tree as port_build_tree

# Small shapes: one intra-op thread.  The JAX CPU backend's worker
# threads share the cores in this process, and torch's OpenMP pool
# then stalls on every small op of the engine loop.
torch.set_num_threads(1)

STATE = ("D", "sD", "N", "Q", "P", "seed", "I", "J", "LI", "LJ")
TDT = {"float64": torch.float64, "float32": torch.float32}


def names(n, cls=Name):
    return [cls(b"t%04d" % i, 48) for i in range(n)]


def int_matrix(n, seed, lo=0, hi=500, drop=0.0):
    rng = np.random.RandomState(seed)
    flat = rng.randint(lo, hi, n * (n - 1) // 2).astype(np.float64)
    if drop:
        flat[rng.rand(len(flat)) < drop] = -1.0
    return flat


def padded(flat, n):
    """The JAX engines' (npad, npad) layout of a loaded matrix."""
    npad = je._pad(n)
    D = np.full((npad, npad), -1.0, np.float64)
    D[:n, :n] = te.square_matrix(flat, n)
    return D


def bits(x):
    x = np.asarray(x)
    return x.view(np.int64 if x.dtype == np.float64 else np.int32)


def assert_records_equal(ours, ref, k, lo=0, rtol=0.0, atol=0.0):
    """Join records lo..k-1 and the last distance: I, J equal, LI, LJ
    and d_last bit-equal (limbs within `rtol` relative or `atol` if
    given)."""
    for name, a, b in zip(("I", "J"), ours[:2], ref[:2]):
        np.testing.assert_array_equal(a[lo:k], np.asarray(b)[lo:k],
                                      err_msg=name)
    for name, a, b in zip(("LI", "LJ"), ours[2:4], ref[2:4]):
        b = np.asarray(b)
        assert a.dtype == b.dtype, name
        if rtol:
            np.testing.assert_allclose(a[lo:k], b[lo:k], rtol=rtol, atol=atol,
                                       err_msg=name)
            continue
        np.testing.assert_array_equal(bits(a[lo:k]), bits(b[lo:k]),
                                      err_msg=name)
    if len(ours) > 4:
        assert float(ours[4]) == float(ref[4])


def run_both(flat, n, dtype="float64", scan="batch", neg_limbs=False):
    """(port records, JAX records) of dnj_joins on one matrix."""
    ours = te.dnj_joins(
        torch.from_numpy(te.square_matrix(flat, n)).to(TDT[dtype]), n,
        neg_limbs=neg_limbs, scan=scan)
    ref = je.dnj_joins(jnp.asarray(padded(flat, n), dtype), jnp.int32(n),
                       neg_limbs=neg_limbs, scan=scan)
    return ours, ref


def assert_newick_equals_host(flat, n, flag=0, scan="batch", precision=9):
    """The port's float64 Newick against the host exact engine of each
    package, each with its own Name class."""
    ours = te.build_tree_float(flat.copy(), n, names(n, PortName), flag,
                               precision, dtype=torch.float64, scan=scan,
                               device="cpu")
    assert ours == build_tree(flat.copy(), n, names(n), "dnj", flag,
                              precision)
    assert ours == port_build_tree(flat.copy(), n, names(n, PortName),
                                   "dnj", flag, precision)


@pytest.mark.parametrize("scan", ["seq", "batch"])
@pytest.mark.parametrize("n", [5, 33, 100, 183])
def test_integer_matrix_matches_jax_and_host(n, scan):
    flat = int_matrix(n, n)
    ours, ref = run_both(flat, n, scan=scan)
    assert_records_equal(ours, ref, n - 2)
    assert_newick_equals_host(flat, n, scan=scan)


@pytest.mark.parametrize("n,hi", [(5, 64), (33, 64), (100, 500)])
def test_float32_records_match_jax(n, hi):
    """float32 state.  With cells below 64 and n <= 33 every row sum
    stays below 2^11, so 13 fractional bits (13 generations of halving)
    still fit 24 bits and both packages are exact.  n = 100 with cells
    below 500 leaves that range (sums reach 2^15); the two engines
    still agree bit for bit on the CPU, where both sum left to
    right."""
    flat = int_matrix(n, n + 1, 0, hi)
    ours, ref = run_both(flat, n, dtype="float32")
    assert_records_equal(ours, ref, n - 2)
    tree = te.build_tree_float(flat.copy(), n, names(n, PortName),
                               dtype=torch.float32, device="cpu")
    assert tree.count(b"(") == tree.count(b")")
    assert tree.count(b",") == n - 1


@pytest.mark.parametrize("scan", ["seq", "batch"])
def test_tie_dense_small_range(scan, n=120):
    """Small integer range: Q ties at nearly every join."""
    flat = int_matrix(n, 97, 0, 25)
    ours, ref = run_both(flat, n, scan=scan)
    assert_records_equal(ours, ref, n - 2)
    assert_newick_equals_host(flat, n, scan=scan)


@pytest.mark.parametrize("scan", ["seq", "batch"])
@pytest.mark.parametrize("drop", [0.02, 0.12])
def test_random_missing_cells(drop, scan, n=72):
    """Random missing cells: updateD's one-sided fallbacks, the
    non-advancing sD/N walker (both-missing cells) and the out-of-row
    garbage read of nj.c:1022.  A one-sided update stores D_ik - L_i,
    and a limb is a quotient, so the cells leave the dyadic range and
    sums round.  Found: the picks equal the JAX engine's at every join,
    its limbs differ from the port's in the last bits (its cumsum does
    not add left to right on the CPU), and the port equals the host
    exact engine, which adds in the C's order, to all 17 digits."""
    flat = int_matrix(n, 31, 1, 60, drop)
    ours, ref = run_both(flat, n, scan=scan)
    assert_records_equal(ours, ref, n - 2, rtol=1e-12)
    assert_newick_equals_host(flat, n, scan=scan)
    assert_newick_equals_host(flat, n, scan=scan, precision=17)


def test_missing_data_early_stop():
    """Unjoinable leftovers: the records read I = J = 0, LI = LJ = -1
    from the first join without a pair, and the tree closes with
    limbless joins (nj.c:1594-1602)."""
    n = 8
    flat = int_matrix(n, 1, 1, 50)
    k = 0
    for i in range(n):
        for j in range(i):
            if i >= 6:  # disconnect nodes 6, 7 from everything
                flat[k] = -1.0
            k += 1
    ours, ref = run_both(flat, n)
    assert_records_equal(ours, ref, n - 2)
    stop = int(np.argmax((ours[0][:n - 2] == 0) & (ours[1][:n - 2] == 0)))
    assert 0 < stop < n - 2
    assert (ours[0][stop:n - 2] == 0).all()
    assert (ours[2][stop:n - 2] == -1).all() \
        and (ours[3][stop:n - 2] == -1).all()
    assert_newick_equals_host(flat, n)


def test_negative_limbs_flag(n=80):
    flat = int_matrix(n, 3, 0, 60)
    ours, ref = run_both(flat, n, neg_limbs=True)
    assert_records_equal(ours, ref, n - 2)
    assert min(ours[2][:n - 2].min(), ours[3][:n - 2].min()) < 0
    assert_newick_equals_host(flat, n, flag=2)


def _quantized(flat, n, bs, npdt):
    qv = np.clip(np.floor(flat * bs + 0.5), 0, np.iinfo(npdt).max)
    return te.square_matrix(qv, n, 0.0).astype(npdt)


@pytest.mark.parametrize("store,compute,bs,hi,n,seed", [
    ("u16", "float64", 1024.0, 60.0, 60, 0),
    ("u16", "float64", 1000.0, 60.0, 60, 1),
    ("u16", "float32", 4.0, 12.0, 33, 2),
    ("u16", "float32", 1000.0, 60.0, 100, 3),
    ("u8", "float64", 16.0, 12.0, 48, 11),
    ("u16", "float64", 1.0, 40000.0, 64, 5)])  # cells above 2^15
def test_quantized_matches_jax_and_host(store, compute, bs, hi, n, seed):
    """u16/u8 ByteScale storage against dnj_joins_q (records) and, with
    float64 compute, against the host exact -s/-b engine (bytes): same
    quantization constants (load 0.5, update 0.25, unquantized sD
    bookkeeping).  Under a power-of-two ByteScale every cell is dyadic
    and the limbs are bit-equal.  Found under ByteScale 1000, where a
    dequantized cell is not: the picks still equal the JAX engine's at
    every join, its limbs differ in the last bits (its cumsum does not
    add left to right on the CPU; tolerance 1e-12 relative in float64;
    in float32, where a limb is a difference of row sums near 6000
    whose ulp is 5e-4, 1e-4 relative or absolute), and the port's bytes
    equal the host engine's."""
    dyadic = bs in (1.0, 4.0, 16.0, 1024.0)
    rtol = 0.0 if dyadic else {"float64": 1e-12, "float32": 1e-4}[compute]
    atol = 1e-4 if rtol == 1e-4 else 0.0
    rng = np.random.RandomState(seed)
    flat = rng.uniform(0.01, hi, n * (n - 1) // 2)
    npdt = {"u16": np.uint16, "u8": np.uint8}[store]
    Dq = _quantized(flat, n, bs, npdt)
    ours = te.dnj_joins_q(te.quant_cells(Dq.copy()), n, bs,
                          compute_dtype=TDT[compute])
    npad = je._pad(n)
    Dqp = np.zeros((npad, npad), npdt)
    Dqp[:n, :n] = Dq
    ref = je.dnj_joins_q(jnp.asarray(Dqp), jnp.int32(n),
                         jnp.asarray(bs, compute), store_dtype=npdt,
                         compute_dtype=jnp.dtype(compute))
    assert_records_equal(ours[:4], ref[:4], n - 2, rtol=rtol, atol=atol)
    assert float(ours[4]) == float(ref[4])
    # the final cells of the last pair, as stored
    assert int(ours[5][1, 0]) & 0xFFFF == int(np.asarray(ref[5])[1, 0])
    tree = te.build_tree_q(flat.copy(), n, names(n, PortName), bytescale=bs,
                           store=store, compute_dtype=TDT[compute],
                           device="cpu")
    if compute == "float64":
        dt = "s" if store == "u16" else "b"
        assert tree == build_tree(flat.copy(), n, names(n), "dnj",
                                  dtype=dt, bytescale=bs)
        assert tree == port_build_tree(flat.copy(), n, names(n, PortName),
                                       "dnj", dtype=dt, bytescale=bs)
    else:
        assert tree.count(b",") == n - 1 and tree.startswith(b"(")


def test_quant_cells_refuses_other_types():
    with pytest.raises(ValueError, match="uint16 or uint8"):
        te.quant_cells(np.zeros((4, 4), np.int32))
    with pytest.raises(ValueError, match="int16"):
        te.dnj_joins_q(torch.zeros((4, 4), dtype=torch.int32), 4, 1.0)
    with pytest.raises(ValueError, match="seq or batch"):
        te.dnj_joins(torch.zeros((4, 4), dtype=torch.float64), 4,
                     scan="fused")


def test_dnj_init_matches_jax(n=100):
    """_dnj_init alone, on the JAX engine's padded matrix with missing
    cells: sD, N, Q, P (initHNJ tie rule) and the seed."""
    D = padded(int_matrix(n, 13, 0, 12, 0.1), n)
    sD, N, Q, P, seed = te._dnj_init(torch.from_numpy(D.copy()), n)
    ref = je._dnj_init(jnp.asarray(D), jnp.int32(n))
    for a, b in zip((sD, N, Q, P), ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(seed) == int(ref[4])


def test_ltd_row_of_is_the_flat_cells_row():
    j = 37
    k = torch.arange(j + 1, 3000)
    f = j * (j - 1) // 2 + k.numpy()
    r = te._ltd_row_of(k, j).numpy()
    assert ((r * (r - 1) // 2 <= f) & (f < (r + 1) * r // 2)).all()
    ref = je._ltd_row_of(jnp.asarray(k.numpy()), jnp.int64(j))
    np.testing.assert_array_equal(r, np.asarray(ref))


@pytest.mark.parametrize("i,j", [(29, 0), (17, 5), (12, 11), (3, 1)])
def test_update_d_exact_matches_jax(i, j, n=32, m_t=30):
    """_update_d_exact alone on a random state with 25% missing cells
    (both-missing walker slots and column only_j garbage reads occur)
    and inactive padding."""
    rng = np.random.RandomState(100 * i + j)
    D = te.square_matrix(int_matrix(n, i + j, 1, 30, 0.25), n)
    D[i, j] = D[j, i] = 7.0
    D[m_t:, :] = D[:, m_t:] = -1.0
    sD = rng.randint(0, 900, n).astype(np.float64)
    N = rng.randint(2, m_t, n).astype(np.int32)
    Li, Lj = 2.5, 4.5
    tD, tsD, tN = (torch.from_numpy(x.copy()) for x in (D, sD, N))
    valid_k, newD = te._update_d_exact(tD, tsD, tN, i, j, Li, Lj, m_t,
                                       torch.arange(n))
    ref = je._update_d_exact(
        jnp.asarray(D), jnp.asarray(sD), jnp.asarray(N), jnp.int32(i),
        jnp.int32(j), jnp.float64(Li), jnp.float64(Lj), jnp.bool_(True),
        jnp.arange(n), jnp.int32(m_t), jnp.float64)
    for a, b in zip((tD, tsD, tN), ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(valid_k.numpy(), np.asarray(ref[3])[:m_t])
    np.testing.assert_array_equal(newD.numpy(), np.asarray(ref[4])[:m_t])


def _active_state_equal(st, ref, m_t):
    """The active part of the port's state against the JAX state."""
    ref = {k: np.asarray(v) for k, v in zip(STATE, ref)}
    cells = "Dq" if "Dq" in st else "D"
    ours = st[cells].numpy()[:m_t, :m_t]
    if cells == "Dq" and ours.dtype == np.int16:
        ours = ours.view(np.uint16)
    np.testing.assert_array_equal(ours, ref["D"][:m_t, :m_t])
    for k in ("sD", "N", "Q"):
        if k in st:
            np.testing.assert_array_equal(st[k].numpy()[:m_t], ref[k][:m_t],
                                          err_msg=k)
    has = ref["Q"][:m_t] != np.finfo(ref["Q"].dtype).max
    np.testing.assert_array_equal(st["P"].numpy()[:m_t][has],
                                  ref["P"][:m_t][has])
    assert int(st["seed"]) == int(ref["seed"])


def _zero_records(D):
    """Fresh I, J, LI, LJ for a JAX segment (each its own buffer: the
    segment donates them)."""
    n = D.shape[0]
    return (jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
            jnp.zeros(n, jnp.float64), jnp.zeros(n, jnp.float64))


def test_state_carried_over_mid_run(n=90, k=30, k2=70):
    """The JAX engine's state after k joins, through
    state_from_jax(float_state=...), runs on in the port: joins k..k2
    and the state after them equal the JAX engine's own."""
    flat = int_matrix(n, 44, 0, 40)
    mj = jnp.int32(n)
    D = jnp.asarray(padded(flat, n))
    state = je._dnj_segment(D, *je._dnj_init(D, mj), *_zero_records(D),
                            jnp.int32(0), jnp.int32(k), mj, scan="batch")
    st = state_from_jax(float_state={
        name: np.array(v) for name, v in zip(STATE, state)})["float_state"]
    _active_state_equal(st, state, n - k)
    ref = je._dnj_segment(*state, jnp.int32(k), jnp.int32(k2), mj,
                          scan="batch")
    te._dnj_segment(st, k, k2, n, scan="batch")
    assert_records_equal([st[x] for x in ("I", "J", "LI", "LJ")], ref[6:],
                         k2)
    _active_state_equal(st, ref, n - k2)


def test_quantized_state_carried_over_mid_run(n=70, k=25, k2=60):
    rng = np.random.RandomState(9)
    flat = rng.uniform(0.01, 60.0, n * (n - 1) // 2)
    bs = 1024.0
    Dq = _quantized(flat, n, bs, np.uint16)
    npad = je._pad(n)
    Dqp = np.zeros((npad, npad), np.uint16)
    Dqp[:n, :n] = Dq
    mj, bsj = jnp.int32(n), jnp.asarray(bs, jnp.float64)
    kw = dict(store_dtype=np.uint16, compute_dtype=jnp.dtype("float64"))
    Dj = jnp.asarray(Dqp)
    init = je._dnj_init_q(Dj, mj, bsj, compute_dtype=kw["compute_dtype"])
    state = je._dnj_segment_q(Dj, *init, *_zero_records(Dj), jnp.int32(0),
                              jnp.int32(k), mj, bsj, **kw)
    qstate = ("Dq", "sD", "Q", "P", "seed", "I", "J", "LI", "LJ")
    st = state_from_jax(float_state={
        name: np.array(v) for name, v in zip(qstate, state)})["float_state"]
    assert st["Dq"].dtype == torch.int16
    ref = je._dnj_segment_q(*state, jnp.int32(k), jnp.int32(k2), mj, bsj,
                            **kw)
    te._dnj_segment_q(st, k, k2, n, bs)
    assert_records_equal([st[x] for x in ("I", "J", "LI", "LJ")], ref[5:],
                         k2)
    full = dict(zip(qstate, ref))
    _active_state_equal(st, [full.get("Dq" if x == "D" else x)
                             for x in STATE], n - k2)


def test_non_integer_float64(n=150):
    """A seeded non-integer float64 matrix.  Found: against the JAX
    engine the port picks the same pairs at every join and the limbs
    are bit-equal (on the CPU both run the same operations in the same
    order, and XLA contracts no multiply-add that changes a pick here);
    against the host exact engine, whose sums run in the C's order, the
    trees have the same shape and every printed limb agrees, but the
    bytes are not asserted: the guaranteed three-way tie at the final
    join resolves on summation ulps."""
    rng = np.random.RandomState(77)
    flat = rng.uniform(0.5, 90.0, n * (n - 1) // 2)
    ours, ref = run_both(flat, n)
    np.testing.assert_array_equal(ours[0][:n - 2], np.asarray(ref[0])[:n - 2])
    np.testing.assert_array_equal(ours[1][:n - 2], np.asarray(ref[1])[:n - 2])
    for a, b in zip(ours[2:4], ref[2:4]):
        np.testing.assert_allclose(a[:n - 2], np.asarray(b)[:n - 2],
                                   rtol=1e-12, atol=0)
    tree = te.build_tree_float(flat.copy(), n, names(n, PortName),
                               dtype=torch.float64, device="cpu")
    host = port_build_tree(flat.copy(), n, names(n, PortName), "dnj")
    assert tree.count(b",") == host.count(b",") == n - 1
    assert len(tree) == len(host)


def _caterpillar(n, seed=7):
    """D_ij = |i - j| plus integer noise in [0, 2]: joins along a chain,
    whose fractional bits pile up with depth."""
    rng = np.random.RandomState(seed)
    i, j = np.tril_indices(n, -1)
    return (i - j + rng.randint(0, 3, len(i))).astype(np.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sums_exact(dtype):
    """sums_exact holds where every partial sum in any order is exact:
    entries on a grid 2^-k whose sum of |x| leaves k fractional bits in
    the p-bit mantissa field, one bit to spare; it fails just past
    that."""
    p = 52 if dtype == torch.float64 else 23
    ok = lambda v: bool(te.sums_exact(torch.tensor(v, dtype=dtype)))
    assert ok([1.0, 2.0, 3.5, -0.25, 0.0])
    assert ok([2.0 ** (p - 1), 1.0])        # 2^(p-1) + 1: p bits
    assert not ok([2.0 ** p, 1.0])          # 2^p + 1: the spare bit too
    assert ok([0.5 ** (p - 2), 1.0])        # p - 2 fractional bits
    assert not ok([0.5 ** p, 1.0])
    x = torch.tensor([[1.0, 0.5 ** (p - 1)], [3.0, 4.0]], dtype=dtype)
    assert te.sums_exact(x, dim=1).tolist() == [False, True]


def test_exact_range_tracking_on_a_caterpillar(n=64):
    """With exact_sums the float64 engines raise InexactSums at the
    first join that could read a row sum that is not exact: dnj on a
    caterpillar does (the cells reach 52 fractional bits), upgma (an
    average per join) stays inside the range and keeps its records."""
    from ccphylo_tpu_torch.tree import hclust_engine as he
    flat = _caterpillar(n)
    with pytest.raises(te.InexactSums) as e:
        te.dnj_joins(torch.from_numpy(te.square_matrix(flat, n)), n,
                     exact_sums=True)
    assert 0 < e.value.join < n - 2
    D = torch.from_numpy(te.square_matrix(flat, n))
    tracked = he.hclust_joins(D.clone(), n, "upgma", exact_sums=True)
    plain = he.hclust_joins(D, n, "upgma")
    for a, b in zip(tracked[:5], plain[:5]):
        np.testing.assert_array_equal(a, b)
    # an integer SNP-like matrix stays exact all the way
    rng = np.random.RandomState(3)
    flat = rng.randint(0, 25, n * (n - 1) // 2).astype(np.float64)
    te.dnj_joins(torch.from_numpy(te.square_matrix(flat, n)), n,
                 exact_sums=True)
