"""The port's process groups (ccphylo_tpu_torch/parallel/multihost.py),
its sharded NJ/UPGMA loop (parallel/sharded_nj.py), its sharded SNP
Gram (ops/snp_torch.sharded_snp_matrix) and the sharded DNJ engine with
KBATCH = 2, against the JAX package's functions on a mesh of as many
virtual CPU devices, on the CPU.

The port's ranks are real processes on gloo (tests/torch_ranks.py), one
job each of 1, 2 and 4 ranks, started once for the module: world 1 with
no process variable (the engines' own one-rank group), 2 and 4 through
CCPHYLO_TORCH_COORDINATOR / _NUM_PROCS / _PROC_ID.  Held at tolerance 0,
but for the sums of the non-integer UPGMA matrices (1e-12 relative:
JAX's CPU sums are not taken left to right).
"""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccphylo_tpu.ops.snp_jax import sharded_snp_matrix as jax_snp_matrix
from ccphylo_tpu.parallel.sharded_nj import \
    sharded_join_records as jax_join_records
from ccphylo_tpu_torch.ops import snp_torch

from .test_torch_sharded import (MULTIPASS, WORLDS, _mesh, check_dnj_records,
                                 check_newick, dnj_jobs, jax_records)
from .torch_ranks import _env, _free_port, start, wait

torch.set_num_threads(1)

# the matrices of tests/test_sharded_nj.py: (method, seed, n); nj on
# wide-range integers, upgma on floats with four decimals
NJ_CASES = [(m, seed, n) for m in ("nj", "upgma")
            for seed, n in ((3, 23), (5, 33), (7, 40))]
NJ_KEYS = ("I", "J", "LI", "LJ", "a", "b", "d_last")
SNP_N, SNP_W, SNP_WCHUNK = 37, 1100, 512


def _rand_square(seed, n, integer):
    rng = np.random.RandomState(seed)
    if integer:
        M = rng.randint(1, 2000, size=(n, n)).astype(np.float64)
    else:
        M = rng.uniform(1, 100, size=(n, n)).round(4)
    D = np.triu(M, 1)
    return D + D.T


def _nj_name(method, seed, n):
    return f"{method}{n}"


def _snp_input():
    """Random u32 words and a shared pair mask (bit 2k = include), as
    int32 bit patterns."""
    rng = np.random.RandomState(5)
    seqs = rng.randint(-2 ** 31, 2 ** 31, (SNP_N, SNP_W)).astype(np.int32)
    pm = (rng.randint(0, 2 ** 32, SNP_W).astype(np.int64)
          & 0x55555555).astype(np.int32)
    return seqs, pm


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's results {world: per-rank results}, the JAX functions'
    {(job, world): outputs}, and (returncode, stderr) of one rank that
    was pointed at a coordinator nobody serves."""
    tmp = tmp_path_factory.mktemp("torch_multihost")
    jobs, arrays = dnj_jobs(MULTIPASS)
    for method, seed, n in NJ_CASES:
        name = _nj_name(method, seed, n)
        jobs.append({"name": name, "kind": "nj", "n": n, "method": method})
        arrays[name + "/D"] = _rand_square(seed, n, method == "nj")
    seqs, pm = _snp_input()
    jobs.append({"name": "snp", "kind": "snp", "wchunk": SNP_WCHUNK})
    arrays.update({"snp/seqs": seqs, "snp/pm": pm})
    procs = start(tmp, jobs, arrays, WORLDS)
    bad = subprocess.Popen(
        [sys.executable, "-c",
         "from ccphylo_tpu_torch.parallel import multihost\n"
         "multihost.maybe_init_distributed(timeout=3)\n"],
        env=_env({"CCPHYLO_TORCH_COORDINATOR": f"127.0.0.1:{_free_port()}",
                  "CCPHYLO_TORCH_NUM_PROCS": "2",
                  "CCPHYLO_TORCH_PROC_ID": "1"}),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    # the JAX side works while the ranks do
    with ThreadPoolExecutor(4) as pool:
        futs = {}
        for method, seed, n in NJ_CASES:
            name = _nj_name(method, seed, n)
            for w in WORLDS:
                futs[(name, w)] = pool.submit(
                    jax_join_records, arrays[name + "/D"], n, _mesh(w),
                    method=method, dtype=jnp.float64)
        for w in WORLDS:
            futs[("snp", w)] = pool.submit(
                jax_snp_matrix, seqs.view(np.uint32), pm.view(np.uint32),
                _mesh(w))
        ref = {key: f.result() for key, f in futs.items()}
    for name, (n, _, kbatch, _) in MULTIPASS.items():
        for w in WORLDS:
            ref[(name, w)] = jax_records(arrays[name + "/D"], n, w, kbatch)
    try:
        _, err = bad.communicate(timeout=120)
    finally:
        if bad.poll() is None:
            bad.kill()
            bad.wait()
    return wait(tmp, procs), ref, (bad.returncode, err)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_dnj_records_multipass(runs, world):
    """KBATCH = 2 (set on the port's module) at n = 144: several passes
    a join, the cross-pass order across ranks."""
    check_dnj_records(*runs[:2], MULTIPASS, "ties144_kbatch2", world)


@pytest.mark.parametrize("world", WORLDS)
def test_build_tree_sharded_dnj_multipass_matches_host_exact(runs, world):
    check_newick(runs[0], MULTIPASS, "ties144_kbatch2", world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("method,seed,n", NJ_CASES)
def test_sharded_join_records(runs, method, seed, n, world):
    """The 7 outputs of sharded_join_records at world W equal JAX's on a
    mesh of W (nj on integer cells bit for bit; upgma's picks and
    survivors bit for bit, its limbs and last distance to 1e-12), on
    every rank."""
    out, ref = runs[:2]
    name = _nj_name(method, seed, n)
    ours = [out[world][0][f"{name}/{k}"] for k in NJ_KEYS]
    for rank in out[world][1:]:
        for a, k in zip(ours, NJ_KEYS):
            np.testing.assert_array_equal(a, rank[f"{name}/{k}"])
    for k, a, b in zip(NJ_KEYS, ours, ref[(name, world)]):
        b = np.asarray(b)
        assert a.dtype == b.dtype, k
        if method == "nj" or k in ("I", "J", "a", "b"):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_snp_matrix(runs, world):
    """Equal to JAX sharded_snp_matrix on a mesh of W and to the port's
    snp_matrix on the same words and mask (the plain expansion on CPU
    tensors)."""
    out, ref = runs[:2]
    seqs, pm = _snp_input()
    single = snp_torch.snp_matrix(torch.from_numpy(seqs), torch.from_numpy(pm),
                                  wchunk=SNP_WCHUNK).numpy()
    for rank in out[world]:
        np.testing.assert_array_equal(rank["snp/D"], ref[("snp", world)])
        np.testing.assert_array_equal(rank["snp/D"], single)


@pytest.mark.parametrize("world", [2, 4])
def test_coordinator_processes_equal_one_process(runs, world):
    """Processes joined through CCPHYLO_TORCH_COORDINATOR give the
    records of one process, bit for bit on integer matrices (as
    tests/test_multiprocess.py checks for JAX); the sums of the
    non-integer UPGMA runs to 1e-12 (another padding, another order)."""
    out = runs[0]
    one = out[1][0]
    for rank in out[world]:
        assert set(rank) == set(one)
        for k in set(one) - {"group"}:
            job, key = k.split("/")
            if job.startswith("upgma") and key in ("LI", "LJ", "d_last"):
                np.testing.assert_allclose(rank[k], one[k], rtol=1e-12,
                                           atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(rank[k], one[k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_process_group(runs, world):
    """maybe_init_distributed: True from the environment of a multi-rank
    job, False with no variable set (row_axis then makes a group of one
    rank); a repeated call is a no-op that returns the same."""
    for r, rank in enumerate(runs[0][world]):
        first, again, got_rank, got_world, size = rank["group"].tolist()
        assert first == again == (world > 1)
        assert (got_rank, got_world, size) == (r, world, world)


def test_bad_coordinator_raises(runs):
    """A rank pointed at a coordinator nobody serves raises when its
    timeout runs out: it never carries on as a separate run."""
    code, err = runs[2]
    assert code != 0
    assert b"DistNetworkError" in err or b"timed out" in err, err[-2000:]
