"""The port's all-pairs SNP counts (ccphylo_tpu_torch/ops/snp_torch.py)
against the JAX package: ops/snp_jax (XLA one-hot) and ops/snp_pallas
(the Pallas expansion, interpreted on the CPU backend).  Integer counts,
so every comparison is bit-exact (tolerance 0).  On the CPU the
expansion wrappers take their plain PyTorch versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccphylo_tpu.ops import snp, snp_jax, snp_pallas
from ccphylo_tpu_torch.ops import build, snp_torch

# Small shapes: one intra-op thread.  The JAX CPU backend's worker
# threads share the cores in this process, and torch's OpenMP pool
# then stalls on every small op of the engine loop.
torch.set_num_threads(1)


def _data(n, W, seed=3):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    pm = rng.integers(0, 2 ** 32, W, dtype=np.uint32) & np.uint32(0x55555555)
    incs = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32) \
        & np.uint32(0x55555555)
    return seqs, pm, incs


def _t(a):
    return snp_torch.u32_tensor(a, "cpu")


@pytest.fixture(scope="module")
def data():
    return _data(128, 512)  # the shapes of tests/test_pallas.py


@pytest.mark.parametrize("rows", [128, 100])  # 100: row padding
def test_shared_counts_match_jax_and_pallas(data, rows):
    seqs, pm, _ = data
    s = seqs[:rows]
    ours = snp_torch.snp_matrix(_t(s), _t(pm), wchunk=512).numpy()
    a = np.asarray(snp_jax.snp_matrix(jnp.asarray(s), jnp.asarray(pm),
                                      wchunk=512))
    b = np.asarray(snp_pallas.snp_matrix(jnp.asarray(s), jnp.asarray(pm),
                                         wchunk=512))
    assert ours.shape == (rows, rows) and ours.dtype == np.int32
    np.testing.assert_array_equal(ours, a)
    np.testing.assert_array_equal(ours, b)


@pytest.mark.parametrize("rows", [128, 100])
def test_pairwise_counts_match_jax_and_pallas(data, rows):
    seqs, _, incs = data
    s, m = seqs[:rows], incs[:rows]
    d, sh = snp_torch.snp_matrix_pairwise(_t(s), _t(m), wchunk=512)
    d1, n1 = snp_jax.snp_matrix_pairwise(jnp.asarray(s), jnp.asarray(m),
                                         wchunk=512)
    d2, n2 = snp_pallas.snp_matrix_pairwise(jnp.asarray(s), jnp.asarray(m),
                                            wchunk=512)
    for ours, ref in ((d, d1), (sh, n1), (d, d2), (sh, n2)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_multiblock_ragged_chunks_match_jax():
    """n > 512 gives several triangular row blocks plus row padding, and
    W = 1100 at wchunk 512 a narrower last genome chunk."""
    seqs, pm, incs = _data(600, 1100, seed=5)
    ours = snp_torch.snp_matrix(_t(seqs), _t(pm), wchunk=512).numpy()
    ref = snp_jax.snp_matrix(jnp.asarray(seqs), jnp.asarray(pm), wchunk=512)
    np.testing.assert_array_equal(ours, np.asarray(ref))
    d, sh = snp_torch.snp_matrix_pairwise(_t(seqs), _t(incs), wchunk=512)
    d1, n1 = snp_jax.snp_matrix_pairwise(jnp.asarray(seqs),
                                         jnp.asarray(incs), wchunk=512)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d1))
    np.testing.assert_array_equal(sh.numpy(), np.asarray(n1))


def test_counts_match_host_numpy_kernels():
    """Through the u64 -> u32 conversion: the port equals the host
    reference kernels of ops/snp.py on the JAX package's own layout."""
    rng = np.random.default_rng(9)
    n, W64 = 40, 24
    s64 = rng.integers(0, 2 ** 63, (n, W64), dtype=np.uint64) * np.uint64(2)\
        + rng.integers(0, 2, (n, W64), dtype=np.uint64)
    inc = rng.integers(0, 2 ** 32, W64, dtype=np.uint32)
    incs = rng.integers(0, 2 ** 32, (n, W64), dtype=np.uint32)
    s32 = _t(snp_torch.u64_to_u32(s64))
    ours = snp_torch.snp_matrix(s32, _t(snp_torch.inc32_to_pairmask(inc)))
    np.testing.assert_array_equal(ours.numpy(),
                                  snp.pairwise_shared(s64, inc))
    d, sh = snp_torch.snp_matrix_pairwise(
        s32, _t(snp_torch.inc32_to_pairmask(incs)))
    hd, hn = snp.pairwise_masked(s64, incs)
    np.testing.assert_array_equal(d.numpy(), hd)
    # the host kernel leaves the (unused) diagonal of `shared` at 0
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_array_equal(sh.numpy()[off], hn[off])


def test_expansion_plain_versions_agree():
    """The shared expansion equals the pairwise one under a broadcast
    mask, and the include plane is the mask's bits; the CPU path
    launches no kernel."""
    seqs, pm, _ = _data(16, 8, seed=2)
    build.reset_launches()
    X = snp_torch.expand_shared(_t(seqs), _t(pm))
    X2, M = snp_torch.expand_pairwise(_t(seqs), _t(np.tile(pm, (16, 1))))
    assert X.shape == (16, 48 * 8) and M.shape == (16, 16 * 8)
    np.testing.assert_array_equal(X.numpy(), X2.numpy())
    bits = (pm[:, None] >> np.arange(30, -1, -2, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(M.numpy()[0], bits.reshape(-1))
    assert set(np.unique(X.numpy())) <= {-1, 0, 1}
    assert all(v == 0 for v in build.launches.values())


@pytest.mark.parametrize("seed", range(3))
def test_u32_helpers_match_snp_jax(seed):
    rng = np.random.default_rng(seed)
    w64 = rng.integers(0, 2 ** 63, 37, dtype=np.uint64) * np.uint64(2) \
        + np.uint64(seed)
    inc = rng.integers(0, 2 ** 32, 37, dtype=np.uint32)
    np.testing.assert_array_equal(snp_torch.u64_to_u32(w64),
                                  snp_jax.u64_to_u32(w64))
    np.testing.assert_array_equal(snp_torch.inc32_to_pairmask(inc),
                                  snp_jax.inc32_to_pairmask(inc))
    # the batched forms equal the per-row reference
    w2 = np.stack([w64, w64[::-1]])
    np.testing.assert_array_equal(
        snp_torch.u64_to_u32(w2)[1], snp_jax.u64_to_u32(w64[::-1]))
    torch.testing.assert_close(
        _t(snp_torch.inc32_to_pairmask(inc)),
        _t(snp_jax.inc32_to_pairmask(inc)), rtol=0, atol=0)
