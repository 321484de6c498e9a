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


# --- the loader's u64 layout (int64 sample words, read in place) -------


def _u64_data(n, W64, seed):
    rng = np.random.default_rng(seed)
    s64 = rng.integers(0, 2 ** 64, (n, W64), dtype=np.uint64)
    inc = rng.integers(0, 2 ** 32, W64, dtype=np.uint32)
    incs = rng.integers(0, 2 ** 32, (n, W64), dtype=np.uint32)
    return s64, inc, incs


@pytest.mark.parametrize("kind", ["shared", "pairwise"])
@pytest.mark.parametrize("rows, W64", [(100, 257), (600, 551)],
                         ids=["rows100", "rows600"])
def test_u64_layout_counts_match(kind, rows, W64):
    """int64 loader words equal the same call on `u64_to_u32` words, the
    host kernels of ops/snp.py and snp_jax: row padding, several row
    blocks (600), and an odd u64 width, so the last wchunk=512 chunk is
    ragged."""
    s64, inc, incs = _u64_data(rows, W64, seed=rows + W64)
    words64 = snp_torch.u64_tensor(s64, "cpu")
    assert words64.dtype == torch.int64
    s32 = snp_torch.u64_to_u32(s64)
    if kind == "shared":
        pm = snp_torch.inc32_to_pairmask(inc)
        ours = snp_torch.snp_matrix(words64, _t(pm), wchunk=512).numpy()
        u32 = snp_torch.snp_matrix(_t(s32), _t(pm), wchunk=512).numpy()
        jx = snp_jax.snp_matrix(jnp.asarray(s32), jnp.asarray(pm),
                                wchunk=512)
        np.testing.assert_array_equal(ours, u32)
        np.testing.assert_array_equal(ours, np.asarray(jx))
        np.testing.assert_array_equal(ours, snp.pairwise_shared(s64, inc))
        return
    pms = snp_torch.inc32_to_pairmask(incs)
    d, sh = snp_torch.snp_matrix_pairwise(words64, _t(pms), wchunk=512)
    d32, sh32 = snp_torch.snp_matrix_pairwise(_t(s32), _t(pms), wchunk=512)
    dj, shj = snp_jax.snp_matrix_pairwise(jnp.asarray(s32),
                                          jnp.asarray(pms), wchunk=512)
    hd, hn = snp.pairwise_masked(s64, incs)
    for ours, ref in ((d, d32), (sh, sh32), (d, dj), (sh, shj)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(d.numpy(), hd)
    off = ~np.eye(rows, dtype=bool)
    np.testing.assert_array_equal(sh.numpy()[off], hn[off])


def test_u64_expansion_equals_u32_expansion():
    """expand_shared and expand_pairwise on int64 words (whole, and a
    column slice of whole u64 words) give the bytes of the converted
    int32 words; and the kernels' view finds u32 word w at index w ^ 1
    with the row stride in u32 words."""
    s64, inc, incs = _u64_data(24, 13, seed=11)
    pm, pms = snp_torch.inc32_to_pairmask(inc), \
        snp_torch.inc32_to_pairmask(incs)
    w64 = snp_torch.u64_tensor(s64, "cpu")
    w32 = _t(snp_torch.u64_to_u32(s64))
    for lo, hi in ((0, 13), (3, 10)):
        a, b = w64[:, lo:hi], w32[:, 2 * lo:2 * hi]
        p, m = _t(pm)[2 * lo:2 * hi], _t(pms)[:, 2 * lo:2 * hi]
        torch.testing.assert_close(snp_torch.expand_shared(a, p),
                                   snp_torch.expand_shared(b, p),
                                   rtol=0, atol=0)
        for x, y in zip(snp_torch.expand_pairwise(a, m),
                        snp_torch.expand_pairwise(b, m)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        v, ld, W, swap = snp_torch._kernel_words(a)
        assert (ld, W, swap) == (2 * 13, 2 * (hi - lo), 1)
        idx = torch.arange(W) ^ swap
        torch.testing.assert_close(v[:, idx], b, rtol=0, atol=0)
    v, ld, W, swap = snp_torch._kernel_words(w32[:, 5:9])
    assert (ld, W, swap) == (26, 4, 0) and v.data_ptr() == \
        w32[:, 5:9].data_ptr()


# --- the loader's include words as per-sample masks ---------------------


def _run_masks(n, W64, seed):
    """(n, W64) u32 include words: each sample's uncalled runs start and
    end at bits 15/16 and 31/0 of an include word (the two halves' and
    the words' edges), plus scattered single uncalled positions."""
    rng = np.random.default_rng(seed)
    L = 32 * W64
    called = rng.random((n, L)) > 0.03
    edges = np.array([0, 15, 16, 31])
    for i in range(n):
        for _ in range(4):
            a = 32 * rng.integers(0, W64) + rng.choice(edges)
            b = 32 * rng.integers(0, W64) + rng.choice(edges)
            a, b = min(a, b), max(a, b) + 1
            called[i, a:b] = False
    return np.packbits(called, axis=1).view(">u4").astype(np.uint32)


def _words(s64, dtype):
    """The loader's u64 words as the int64 tensor, or converted to the
    int32 (u32 hi-first) tensor."""
    if dtype == "int64":
        return snp_torch.u64_tensor(s64, "cpu")
    return _t(snp_torch.u64_to_u32(s64))


@pytest.mark.parametrize("dtype", ["int64", "int32"])
@pytest.mark.parametrize("rows, W64", [(100, 257), (600, 551)],
                         ids=["rows100", "rows600"])
def test_inc_word_counts_match(dtype, rows, W64):
    """`snp_matrix_pairwise` on the loader's include words (W/2 columns)
    equals it on their pair masks, snp_jax and the host kernels of
    ops/snp.py: row padding, several row blocks (600) and an odd u64
    width, so the last wchunk=512 chunk is ragged."""
    s64 = _u64_data(rows, W64, seed=rows + W64 + 1)[0]
    incs = _run_masks(rows, W64, seed=rows)
    words = _words(s64, dtype)
    pms = snp_torch.inc32_to_pairmask(incs)
    d, sh = snp_torch.snp_matrix_pairwise(words, _t(incs), wchunk=512)
    dp, shp = snp_torch.snp_matrix_pairwise(words, _t(pms), wchunk=512)
    dj, shj = snp_jax.snp_matrix_pairwise(
        jnp.asarray(snp_torch.u64_to_u32(s64)), jnp.asarray(pms), wchunk=512)
    hd, hn = snp.pairwise_masked(s64, incs)
    for ours, ref in ((d, dp), (sh, shp), (d, dj), (sh, shj)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(d.numpy(), hd)
    off = ~np.eye(rows, dtype=bool)
    np.testing.assert_array_equal(sh.numpy()[off], hn[off])


@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_inc_word_expansion_equals_pair_mask_expansion(dtype):
    """expand_pairwise_plain (and expand_pairwise on the CPU) on include
    words gives the X and M bytes of the same call on their pair masks:
    whole rows, and a column slice of whole u64 words."""
    s64 = _u64_data(24, 13, seed=12)[0]
    incs = _run_masks(24, 13, seed=13)
    words, inc = _words(s64, dtype), _t(incs)
    pms = _t(snp_torch.inc32_to_pairmask(incs))
    k = 1 if dtype == "int64" else 2     # word columns a u64 word takes
    for lo, hi in ((0, 13), (3, 10)):
        s = words[:, k * lo:k * hi]
        want = snp_torch.expand_pairwise_plain(s, pms[:, 2 * lo:2 * hi])
        for fn in (snp_torch.expand_pairwise_plain,
                   snp_torch.expand_pairwise):
            for got, ref in zip(fn(s, inc[:, lo:hi]), want):
                torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_inc_words_need_an_even_width():
    """An odd-W int32 slice cannot take include words: W / 2 columns is
    no whole number, and neither width is a pair mask's."""
    s32 = _t(snp_torch.u64_to_u32(_u64_data(8, 4, seed=14)[0]))[:, 1:8]
    for cols in (3, 4):
        inc = _t(_run_masks(8, 4, seed=15))[:, :cols]
        with pytest.raises(ValueError, match="include"):
            snp_torch.expand_pairwise_plain(s32, inc)
        with pytest.raises(ValueError, match="include"):
            snp_torch.snp_matrix_pairwise(s32, inc)
