"""The parity chain of chip_smoke.py's `parity` phase on CPU tensors: the
synthetic hash matrix of benchmarks/synth.py made by the port
(`hash_cells`, `hash_words`), the port's packed engine (the plain
segment on the CPU), `limbs_host` and `_records_to_newick` on the
Phylip loader's names, against the JAX package's chain on the same
matrix (`device_words`, its packed engine, `limbs_host`,
`_records_to_newick`) and against the port's host exact -b engine.
Everything compared is an integer or bytes: tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
import ccphylo_tpu.tree.packed_engine as jpe
from benchmarks.synth import cell_hash_np, device_words
from ccphylo_tpu.io.qseqs import Name as JaxName
from ccphylo_tpu.tree.jax_engine import _records_to_newick as jax_newick
from ccphylo_tpu_torch.tree import packed_engine as tpe
from ccphylo_tpu_torch.tree.exact import build_tree

# small shapes: one intra-op thread (torch's pool stalls beside JAX's)
torch.set_num_threads(1)

_RNG = np.random.default_rng(11)
# index vectors (i, j) of cell pairs, by region
PAIRS = {
    "near 0": np.meshgrid(np.arange(64), np.arange(64)),
    "512-row pad boundary": np.meshgrid(np.arange(480, 544),
                                        np.arange(480, 544)),
    "near 2**16": np.meshgrid(np.arange(2 ** 16 - 32, 2 ** 16 + 32),
                              np.arange(2 ** 16 - 40, 2 ** 16 + 24)),
    "near 2**17": np.meshgrid(np.arange(2 ** 17 - 32, 2 ** 17 + 32),
                              np.arange(2 ** 17 - 24, 2 ** 17 + 40)),
    "rows 99,000-100,351": (_RNG.integers(99_000, 100_352, 8192),
                            np.concatenate([
                                _RNG.integers(99_000, 100_352, 4096),
                                _RNG.integers(0, 100_352, 4096)])),
}


@pytest.mark.parametrize("region", sorted(PAIRS))
def test_hash_cells_match_synth(region):
    """The port's hash on int64 tensors, and the smoke run's numpy copy,
    equal benchmarks.synth.cell_hash_np cell for cell, in both orders of
    (i, j)."""
    i, j = (np.ravel(x).astype(np.int64) for x in PAIRS[region])
    want = cell_hash_np(i, j)
    ours = cs.hash_cells(torch.from_numpy(i), torch.from_numpy(j))
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), want)
    np.testing.assert_array_equal(
        cs.hash_cells(torch.from_numpy(j), torch.from_numpy(i)).numpy(), want)
    np.testing.assert_array_equal(cs.hash_cells_np(i, j), want)
    assert (want[i == j] == 0).all() and (want[i != j] >= 3).all()


def _jax_chain(n):
    """benchmarks.synth.device_words -> the JAX packed engine ->
    limbs_host -> _records_to_newick, names as the Phylip loader makes
    them.  Returns (words, Newick, records digest)."""
    words = device_words(n)
    host_words = np.asarray(words).copy()  # the engine donates `words`
    out = jpe.dnj_joins_packed(words, jnp.int32(n), kbatch=cs.KBATCH)
    k = n - 2
    rec = [np.asarray(x)[:k] for x in out[:5]]
    LI, LJ = jpe.limbs_host(*out[:5], n, 1.0)
    names = []
    for i in range(n):
        nm = JaxName(b"", 4 if i < 32 else 32)
        nm.grow_for(9)
        nm.data = b"T%07d" % i
        names.append(nm)
    nwk = jax_newick(rec[0], rec[1], LI, LJ, int(np.asarray(out[5])) / 2.0,
                     n, names, 0, 9)
    return host_words, nwk + b";\n", cs.records_digest(rec, n)


@pytest.mark.parametrize("n", [300, 700])
def test_chain_matches_jax_and_host(n):
    """hash_words equals device_words word for word (zero padding
    included); the port's Newick and records digest equal the JAX
    chain's, and the Newick equals the port's host exact -b engine's."""
    words = cs.hash_words(n, "cpu")
    jwords, jnwk, jdigest = _jax_chain(n)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jwords)
    assert cs.spot_check(words, n) == 0
    out = tpe.dnj_joins_packed(words, n, kbatch=cs.KBATCH)
    nwk = cs.parity_newick(out, n)
    assert nwk == jnwk
    assert cs.records_digest(out, n) == jdigest
    iu = np.tril_indices(n, -1)
    flat = cell_hash_np(iu[0], iu[1]).astype(np.float64)
    host = build_tree(flat, n, cs.parity_names(n), "dnj", dtype="b",
                      bytescale=1.0)
    assert nwk == host + b";\n"
    assert nwk.startswith(b"(") and nwk.count(b"T0") == n


def test_spot_check_sees_a_wrong_cell():
    """The smoke run's spot check counts a changed cell in the tail rows
    and one in the padding."""
    n = 600
    words = cs.hash_words(n, "cpu")
    D8 = words.view(torch.uint8)
    D8[n - 1, n - 2] ^= 1
    D8[words.shape[0] - 1, words.shape[0] - 1] = 7
    assert cs.spot_check(words, n) == 2


def test_first_difference():
    assert cs.first_difference(b"abc", b"abd") == 2
    assert cs.first_difference(b"ab", b"abc") == 2
    assert cs.first_difference(b"abc", b"abc") == 3
