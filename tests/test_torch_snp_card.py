"""The SNP expansion kernels (ccphylo_tpu_torch/csrc/snp_expand.cu) on
the card, fed the .fsa loader's u64 words as an int64 tensor: both
kernels, on whole rows and on a column slice (row stride != width),
equal their plain PyTorch versions and their own output on the
converted int32 words, bit for bit; `snp_matrix` and
`snp_matrix_pairwise` on int64 words equal the int32 route and the host
numpy kernels.  The pairwise kernel on the loader's u32 include words
(one per u64 word) equals it on their pair masks and its plain version,
on both word layouts, whole and column-sliced, and so do the counts.
Both dist seams of the CLI fill their padded buffers on the card
through `padded_rows`' ring of pinned blocks (forced small: more blocks
than slots, a partial last block): the buffers hold the rows exactly,
the counts equal the plain versions', each block counts one
`dist/ring_blocks`, and a fill's device memory peak leaves no room for
a second copy of the words.

Every test needs an NVIDIA card (marker `card`) and skips without one:
a CUDA kernel has no CPU mode.  This file imports neither JAX nor the
JAX package.  On a machine with a card, from the root of a checkout
(--noconftest: tests/conftest.py sets up JAX for the CPU tests):

    python -m pytest --noconftest tests/test_torch_snp_card.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ccphylo_tpu_torch.cli import dist_cmd
from ccphylo_tpu_torch.ops import snp, snp_torch
from ccphylo_tpu_torch.utils import timing

pytestmark = pytest.mark.card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _data(n, W64, seed):
    rng = np.random.default_rng(seed)
    s64 = rng.integers(0, 2 ** 64, (n, W64), dtype=np.uint64)
    inc = rng.integers(0, 2 ** 32, W64, dtype=np.uint32)
    incs = rng.integers(0, 2 ** 32, (n, W64), dtype=np.uint32)
    return s64, inc, incs


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


@pytest.mark.parametrize("cols", [None, (7, 1031)], ids=["whole", "slice"])
def test_u64_kernels_equal_plain(dev, cols):
    s64, inc, incs = _data(1000, 1100, seed=21)
    w64 = snp_torch.u64_tensor(s64, dev)
    w32 = snp_torch.u32_tensor(snp_torch.u64_to_u32(s64), dev)
    pm = snp_torch.u32_tensor(snp_torch.inc32_to_pairmask(inc), dev)
    pms = snp_torch.u32_tensor(snp_torch.inc32_to_pairmask(incs), dev)
    if cols is not None:
        lo, hi = cols
        w64, w32 = w64[:, lo:hi], w32[:, 2 * lo:2 * hi]
        pm, pms = pm[2 * lo:2 * hi], pms[:, 2 * lo:2 * hi]
        assert w64.stride(0) != w64.shape[1]
    X = snp_torch.expand_shared(w64, pm)
    _same(X, snp_torch.expand_shared_plain(w64, pm))
    _same(X, snp_torch.expand_shared(w32, pm))
    XM = snp_torch.expand_pairwise(w64, pms)
    for got, plain, u32 in zip(XM, snp_torch.expand_pairwise_plain(w64, pms),
                               snp_torch.expand_pairwise(w32, pms)):
        _same(got, plain)
        _same(got, u32)


@pytest.mark.parametrize("kind", ["shared", "pairwise"])
def test_u64_counts_on_the_card(dev, kind):
    """600 rows (several row blocks, padding), an odd u64 width at
    wchunk=512 (a ragged last chunk)."""
    s64, inc, incs = _data(600, 551, seed=22)
    w64 = snp_torch.u64_tensor(s64, dev)
    w32 = snp_torch.u32_tensor(snp_torch.u64_to_u32(s64), dev)
    if kind == "shared":
        pm = snp_torch.u32_tensor(snp_torch.inc32_to_pairmask(inc), dev)
        got = snp_torch.snp_matrix(w64, pm, wchunk=512)
        _same(got, snp_torch.snp_matrix(w32, pm, wchunk=512))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      snp.pairwise_shared(s64, inc))
        return
    pms = snp_torch.u32_tensor(snp_torch.inc32_to_pairmask(incs), dev)
    d, sh = snp_torch.snp_matrix_pairwise(w64, pms, wchunk=512)
    d32, sh32 = snp_torch.snp_matrix_pairwise(w32, pms, wchunk=512)
    _same(d, d32)
    _same(sh, sh32)
    hd, hn = snp.pairwise_masked(s64, incs)
    np.testing.assert_array_equal(d.cpu().numpy(), hd)
    off = ~np.eye(600, dtype=bool)
    np.testing.assert_array_equal(sh.cpu().numpy()[off], hn[off])


def _run_masks(n, W64, seed):
    """(n, W64) u32 include words whose uncalled runs start and end at
    bits 15/16 and 31/0 of a word, plus scattered uncalled positions."""
    rng = np.random.default_rng(seed)
    called = rng.random((n, 32 * W64)) > 0.03
    edges = np.array([0, 15, 16, 31])
    for i in range(n):
        for _ in range(4):
            a = 32 * rng.integers(0, W64) + rng.choice(edges)
            b = 32 * rng.integers(0, W64) + rng.choice(edges)
            called[i, min(a, b):max(a, b) + 1] = False
    return np.packbits(called, axis=1).view(">u4").astype(np.uint32)


def _words(s64, dtype, dev):
    if dtype == "int64":                                    # swap = 1
        return snp_torch.u64_tensor(s64, dev)
    return snp_torch.u32_tensor(snp_torch.u64_to_u32(s64), dev)  # swap 0


@pytest.mark.parametrize("dtype", ["int64", "int32"])
@pytest.mark.parametrize("cols", [None, (7, 1031)], ids=["whole", "slice"])
def test_inc_word_kernel_equals_pair_masks_and_plain(dev, dtype, cols):
    s64 = _data(1000, 1100, seed=23)[0]
    incs = _run_masks(1000, 1100, seed=24)
    w = _words(s64, dtype, dev)
    inc = snp_torch.u32_tensor(incs, dev)
    pms = snp_torch.u32_tensor(snp_torch.inc32_to_pairmask(incs), dev)
    if cols is not None:
        lo, hi = cols
        k = 1 if dtype == "int64" else 2
        w, inc, pms = w[:, k * lo:k * hi], inc[:, lo:hi], pms[:, 2 * lo:2 * hi]
        assert inc.stride(0) != inc.shape[1]
    XM = snp_torch.expand_pairwise(w, inc)
    for got, pair, plain in zip(XM, snp_torch.expand_pairwise(w, pms),
                                snp_torch.expand_pairwise_plain(w, inc)):
        _same(got, pair)
        _same(got, plain)


@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_inc_word_counts_on_the_card(dev, dtype):
    """600 rows (several row blocks, padding), an odd u64 width at
    wchunk=512 (a ragged last chunk)."""
    s64 = _data(600, 551, seed=25)[0]
    incs = _run_masks(600, 551, seed=26)
    w = _words(s64, dtype, dev)
    d, sh = snp_torch.snp_matrix_pairwise(
        w, snp_torch.u32_tensor(incs, dev), wchunk=512)
    dp, shp = snp_torch.snp_matrix_pairwise(
        w, snp_torch.u32_tensor(snp_torch.inc32_to_pairmask(incs), dev),
        wchunk=512)
    _same(d, dp)
    _same(sh, shp)
    hd, hn = snp.pairwise_masked(s64, incs)
    np.testing.assert_array_equal(d.cpu().numpy(), hd)
    off = ~np.eye(600, dtype=bool)
    np.testing.assert_array_equal(sh.cpu().numpy()[off], hn[off])


@pytest.fixture
def seam_env(dev, monkeypatch):
    """The CLI's default route (the card), tracing off unless a profiler
    records, counters empty."""
    for k in ("CCPHYLO_TORCH_DEVICE", "CCPHYLO_TORCH_DIST",
              "CCPHYLO_TORCH_DIST_CKPT", "CCPHYLO_TORCH_PROFILE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(timing, "_MODE", "")
    monkeypatch.setattr(timing, "_spans", {})
    monkeypatch.setattr(timing, "_counters", {})
    return dev


def _fill_inputs(samples, W64, seed):
    """Per-sample arrays as the .fsa loader hands them (u64 words, u32
    include words, each its own array), the shared include words, and a
    fill that leaves out every 37th sample."""
    s64, inc, _ = _data(samples, W64, seed)
    incs = _run_masks(samples, W64, seed + 1)
    idxs = [i for i in range(samples) if i % 37 != 5]
    return ([np.array(r) for r in s64], [np.array(r) for r in incs], inc,
            idxs)


def _blocks(rows, W64, item):
    R = max(1, snp_torch.SLOT_BYTES // (W64 * item))
    assert rows % R and -(-rows // R) > snp_torch.RING_SLOTS
    return -(-rows // R)


@pytest.mark.parametrize("kind", ["shared", "pairwise"])
def test_ring_fills_the_padded_buffer(seam_env, monkeypatch, kind):
    """303 rows in blocks of 7 u64 rows (14 include-word rows): more
    blocks than slots, a partial last block.  `padded_rows` holds the
    rows and zero padding to 384 rows, the seam's counts equal the plain
    versions' on the CPU, and every block counts one dist/ring_blocks."""
    dev = seam_env
    W64 = 96
    monkeypatch.setattr(snp_torch, "SLOT_BYTES", 7 * 8 * W64)
    s64, incs, inc, idxs = _fill_inputs(312, W64, seed=27)
    n = len(idxs)
    words = [s64[i] for i in idxs]
    masks = [incs[i] for i in idxs]
    bufs = [snp_torch.padded_rows(words, dev)]
    if kind == "pairwise":
        bufs.append(snp_torch.padded_rows(masks, dev))
    for buf, rows, np_dt in zip(bufs, (words, masks),
                                (np.uint64, np.uint32)):
        host = buf.cpu().numpy().view(np_dt)
        assert host.shape == (384, W64)
        np.testing.assert_array_equal(host[:n], np.stack(rows))
        assert not host[n:].any()
    with profile(activities=[ProfilerActivity.CPU]):
        if kind == "shared":
            got = dist_cmd._batch_shared(s64, idxs, inc)
        else:
            got = dist_cmd._batch_pairwise(s64, incs, idxs)
    blocks = _blocks(n, W64, 8)
    if kind == "shared":
        pm = snp_torch.u32_tensor(snp_torch.inc32_to_pairmask(inc), "cpu")
        plain = snp_torch.snp_matrix(
            snp_torch.u64_tensor(np.stack(words), "cpu"), pm).numpy()
        np.testing.assert_array_equal(got, plain)
    else:
        blocks += _blocks(n, W64, 4)
        plain = snp_torch.snp_matrix_pairwise(
            snp_torch.u64_tensor(np.stack(words), "cpu"),
            snp_torch.u32_tensor(np.stack(masks), "cpu"))
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(g, p.numpy())
    assert timing.counters()["dist/ring_blocks"] == blocks
    assert timing.counters()["dist/direct_fills"] == 1


# device bytes a fill may hold beyond its padded buffers, one expansion
# chunk and eight npad x npad int32 matrices (the Grams, their mirrored
# copies and the int8 products' outputs): the mask and the allocator's
# rounding; a second copy of the words (48 MiB here) would pass it
_MARGIN = 4 << 20


@pytest.mark.parametrize("kind", ["shared", "pairwise"])
def test_fill_peak_holds_one_copy_of_the_words(seam_env, monkeypatch, kind):
    """Wide rows (16384 u64 words: a 48 MiB padded buffer) through a
    ring of 1 MiB blocks: the fill's device memory peak stays within the
    padded buffers, one expansion chunk, the Grams and _MARGIN, and the
    counts equal those of the public entry points on the stacked words
    (which pad a copy)."""
    dev = seam_env
    W64 = 16384
    monkeypatch.setattr(snp_torch, "SLOT_BYTES", 1 << 20)
    s64, incs, inc, idxs = _fill_inputs(312, W64, seed=29)
    n = len(idxs)
    B, npad, wc = snp_torch._layout(n, 2 * W64, None)
    words = np.stack([s64[i] for i in idxs])
    pm = snp_torch.u32_tensor(snp_torch.inc32_to_pairmask(inc), dev)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    if kind == "shared":
        got = dist_cmd._batch_shared(s64, idxs, inc)
        held = npad * W64 * 8 + npad * 48 * wc
    else:
        got = dist_cmd._batch_pairwise(s64, incs, idxs)
        held = npad * W64 * (8 + 4) + npad * (48 + 16) * wc
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    bound = held + 8 * npad * npad * 4 + _MARGIN
    assert peak <= bound, (peak, bound)
    w = snp_torch.u64_tensor(words, dev)
    if kind == "shared":
        np.testing.assert_array_equal(
            got, snp_torch.snp_matrix(w, pm).cpu().numpy())
        return
    ref = snp_torch.snp_matrix_pairwise(
        w, snp_torch.u32_tensor(np.stack([incs[i] for i in idxs]), dev))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.cpu().numpy())
