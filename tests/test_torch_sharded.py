"""The port's sharded DNJ engine (ccphylo_tpu_torch/parallel/sharded_dnj.py)
against the JAX package's (ccphylo_tpu/parallel/sharded_dnj.py), the
port's single-card batch engine and the host exact engine, on the CPU.

The port's ranks are real processes on gloo (tests/torch_ranks.py): one
job each of 1, 2 and 4 ranks runs every matrix, started once for the
module; the JAX engine runs here on a mesh of as many virtual CPU
devices, while they work.  The matrices are those of
tests/test_sharded_dnj.py; the one run with KBATCH = 2 is held in
tests/test_torch_multihost.py, on another pytest worker.  Picks (I, J) are held bit for bit; limbs
and the last distance too on integer matrices, and within 1e-12 of the
JAX engine's otherwise (its CPU sums are not taken left to right; the
port's equal the single-card engine's bit for bit).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import ccphylo_tpu.parallel.sharded_dnj as jsd
from ccphylo_tpu_torch.io.qseqs import Name
from ccphylo_tpu_torch.tree import torch_engine as te
from ccphylo_tpu_torch.tree.exact import build_tree

from .torch_ranks import start, wait

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
HANDOVER_N, HANDOVER_MESH = 64, 2


def _rand_flat(n, seed, missing=0.0):
    rng = np.random.RandomState(seed)
    flat = rng.uniform(0.01, 1.0, n * (n - 1) // 2)
    if missing:
        flat[rng.rand(len(flat)) < missing] = -1.0
    return flat


def _int_flat(n, seed, hi):
    rng = np.random.RandomState(seed)
    return rng.randint(0, hi, n * (n - 1) // 2).astype(np.float64)


# name -> (n, loaded ltd matrix, KBATCH or None, integer cells)
CASES = {
    "continuous37": (37, _rand_flat(37, 0), None, False),
    "continuous64": (64, _rand_flat(64, 1), None, False),
    "missing48": (48, _rand_flat(48, 7, missing=0.15), None, False),
    "ties160": (160, _int_flat(160, 41, 25), None, True),
}
# KBATCH = 2 forces several passes a join, the cross-pass order across
# ranks; its jobs run in tests/test_torch_multihost.py, beside these
MULTIPASS = {"ties144_kbatch2": (144, _int_flat(144, 3, 20), 2, True)}


def _mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("d",))


def jax_records(D, n, world, kbatch):
    """JAX sharded_dnj_records on a mesh of `world` devices, in float64,
    KBATCH set on the JAX module for the run."""
    old = jsd.KBATCH
    jsd._dnj_programs.cache_clear()
    jsd.KBATCH = kbatch
    try:
        return jsd.sharded_dnj_records(D, n, _mesh(world), dtype=jnp.float64)
    finally:
        jsd.KBATCH = old
        jsd._dnj_programs.cache_clear()


def _jax_state_after(D, n, world, t):
    """The JAX engine's state tuple after its first t joins, as numpy
    arrays: the set-up of jsd.sharded_dnj_records, then one seg_fn."""
    mesh = _mesh(world)
    npad = jsd._pad_to(n, 128 * world)
    Dp = np.full((npad, npad), -1.0)
    Dp[:n, :n] = D
    np.fill_diagonal(Dp[:n, :n], 0.0)
    Dd = jax.device_put(Dp, NamedSharding(mesh, PartitionSpec("d", None)))
    init_fn, seg_fn = jsd._dnj_programs(mesh, "d", npad, n, "float64", False)
    rep = NamedSharding(mesh, PartitionSpec())
    recs = [jax.device_put(np.zeros(n - 2, dt), rep)
            for dt in (np.int32, np.int32, np.float64, np.float64)]
    state = (Dd, *init_fn(Dd), *recs)
    state = seg_fn(*state, jnp.int32(0), jnp.int32(t))
    return [np.asarray(x) for x in state]


def dnj_jobs(cases):
    """The rank jobs and arrays of DNJ `cases` (records; Newick too on
    integer matrices)."""
    jobs, arrays = [], {}
    for name, (n, flat, kbatch, integer) in cases.items():
        job = {"name": name, "kind": "dnj", "n": n, "newick": integer}
        if kbatch:
            job["kbatch"] = kbatch
        jobs.append(job)
        arrays[name + "/D"] = te.square_matrix(flat, n)
    return jobs, arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: per-rank results} of the port's jobs, and the JAX
    engine's records {(case, world): (I, J, LI, LJ, d_last)}."""
    tmp = tmp_path_factory.mktemp("torch_sharded")
    jobs, arrays = dnj_jobs(CASES)
    n = HANDOVER_N
    D = te.square_matrix(_int_flat(n, 11, 25), n)
    state = _jax_state_after(D, n, HANDOVER_MESH, n // 2)
    jobs.append({"name": "handover", "kind": "handover", "n": n,
                 "t": n // 2})
    arrays.update({f"handover/s{k}": s for k, s in enumerate(state)})
    procs = start(tmp, jobs, arrays, WORLDS)
    # the JAX side works while the ranks do, the runs side by side
    # (compiling takes most of their time)
    with ThreadPoolExecutor(4) as pool:
        futs = {(name, w): pool.submit(
            jsd.sharded_dnj_records, arrays[name + "/D"], c[0], _mesh(w),
            dtype=jnp.float64)
            for name, c in CASES.items() for w in WORLDS}
        futs[("handover", 0)] = pool.submit(
            jsd.sharded_dnj_records, D, n, _mesh(HANDOVER_MESH),
            dtype=jnp.float64)
        ref = {key: f.result() for key, f in futs.items()}
    return wait(tmp, procs), ref


def _rec(res, name, T):
    """The records of job `name` cut to its T joins, d_last last."""
    return [res[f"{name}/{k}"][:T] for k in ("I", "J", "LI", "LJ")] \
        + [res[f"{name}/d_last"]]


def _cut(rec, T):
    return [np.asarray(x)[:T] for x in rec[:4]] + [np.asarray(rec[4])]


def check_dnj_records(out, ref, cases, case, world):
    """Port at world W == JAX on a mesh of W, == the port's single-card
    batch engine, and the same on every rank."""
    n, flat, _, integer = cases[case]
    T = n - 2
    ours = _rec(out[world][0], case, T)
    for rank in out[world][1:]:
        for a, b in zip(ours, _rec(rank, case, T)):
            np.testing.assert_array_equal(a, b)
    jax_rec = _cut(ref[(case, world)], T)
    for k in (0, 1):  # I, J
        np.testing.assert_array_equal(ours[k], jax_rec[k])
    for k in (2, 3, 4):  # LI, LJ, d_last
        if integer:
            np.testing.assert_array_equal(ours[k], jax_rec[k])
        else:
            np.testing.assert_allclose(ours[k], jax_rec[k], rtol=1e-12,
                                       atol=0)
    single = te.dnj_joins(torch.from_numpy(te.square_matrix(flat, n)), n,
                          scan="batch")
    for a, b in zip(ours, _cut(single, T)):
        np.testing.assert_array_equal(a, b)


def check_newick(out, cases, case, world):
    """Tie-dense integer matrices: the Newick bytes of
    build_tree_sharded_dnj on every rank are the host exact engine's."""
    n, flat, _, _ = cases[case]
    names = [Name(b"t%03d" % i, 32) for i in range(n)]
    exact = build_tree(flat.copy(), n, names, "dnj")
    for rank in out[world]:
        assert rank[case + "/newick"].tobytes() == exact


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_dnj_records(runs, case, world):
    check_dnj_records(*runs, CASES, case, world)


@pytest.mark.parametrize("world", WORLDS)
def test_build_tree_sharded_dnj_matches_host_exact(runs, world):
    check_newick(runs[0], CASES, "ties160", world)


@pytest.mark.parametrize("world", WORLDS)
def test_jax_run_handed_over_half_way(runs, world):
    """JAX init_fn + seg_fn to t = n/2 on a mesh of 2, then the port's
    ranks from interop.sharded_state_from_jax: the records of an
    uninterrupted JAX run."""
    out, ref = runs
    T = HANDOVER_N - 2
    for rank in out[world]:
        for a, b in zip(_rec(rank, "handover", T), _cut(ref[("handover", 0)], T)):
            np.testing.assert_array_equal(a, b)
