"""The generator repeats exactly for a seed and hands each seam the
layout of the program's loaders."""

import numpy as np
import pytest
import torch

from port_bench.gen import collection
from port_bench.tests.conftest import tiny_config

SEED = 3_141_592_653_589


def test_distances_repeat_for_a_seed():
    cfg = tiny_config("tiny")
    a = collection.distances(cfg, SEED, 1, "cpu")
    assert np.array_equal(a, collection.distances(cfg, SEED, 1, "cpu"))
    assert not np.array_equal(a, collection.distances(cfg, SEED, 2, "cpu"))
    assert not np.array_equal(a, collection.distances(cfg, SEED + 1, 1,
                                                      "cpu"))
    n = cfg["n"]
    assert a.shape == (n * (n - 1) // 2,) and a.dtype == np.float64
    assert (a == np.floor(a)).all() and (a >= 0).all()


def test_alignment_repeats_for_a_seed():
    cfg = tiny_config("tiny")
    s, i = collection.alignment(cfg, SEED, 0, "cpu")
    s2, i2 = collection.alignment(cfg, SEED, 0, "cpu")
    assert np.array_equal(s, s2) and np.array_equal(i, i2)
    assert not np.array_equal(s, collection.alignment(cfg, SEED, 1,
                                                      "cpu")[0])


@pytest.mark.parametrize("k", [0, 1])
def test_distances_count_differing_bases(k):
    cfg = tiny_config("tiny")
    X, keep = collection._bases(cfg, SEED, "distances", k, "cpu",
                                full=False)
    x = X.numpy()
    want = ((x[:, None, :] != x[None, :, :]) & keep.numpy()).sum(-1)
    got = int(keep.sum()) - collection.gram_equal(X, keep).numpy()
    assert np.array_equal(got, want)


def test_the_clone_descends_from_its_first_isolate():
    """Each isolate descends from an earlier one and lies as many SNPs
    from it as its own substitutions, less those the mask drops or that
    fall on one position twice."""
    cfg = tiny_config("tiny")
    n = cfg["n"]
    g = torch.Generator()
    g.manual_seed(collection.stream_seed(SEED, "distances", 0))
    parent, nmut, pos, _ = collection._events(cfg, g, "cpu")
    assert parent[0] == -1 and (parent[1:] < torch.arange(1, n)).all()
    assert nmut[0] == 0 and int(nmut.sum()) == pos.numel()
    D = np.zeros((n, n))
    D[np.tril_indices(n, -1)] = collection.distances(cfg, SEED, 0, "cpu")
    D = D + D.T
    d = D[np.arange(1, n), parent[1:].numpy()]
    m = nmut[1:].numpy()
    assert (d <= m).all() and (d == m).mean() > 0.9 and m.sum() > n


def test_alignment_is_the_fsa_loaders_layout():
    """Unpacked with the program's loader helpers, the words are the
    generator's bases, and the mask leaves out the tail past L."""
    from ccphylo_tpu_torch.ops import pack2bit
    cfg = tiny_config("tiny")
    L = cfg["genome_bp"]
    seqs, inc = collection.alignment(cfg, SEED, 0, "cpu")
    X, keep = collection._bases(cfg, SEED, "alignment", 0, "cpu",
                                full=True)
    for r in (0, 7, cfg["n"] - 1):
        codes = X[r, :L].numpy()
        assert np.array_equal(pack2bit.unpack_2bit(seqs[r], L), codes)
        assert np.array_equal(pack2bit.pack_2bit(codes)[0], seqs[r])
    assert np.array_equal(pack2bit.mask_words_to_bits(inc, L),
                          keep[:L].numpy())
    assert np.array_equal(inc & pack2bit.init_inc_pos(L), inc)
    assert 0.97 < keep[:L].float().mean() < 1.0


def test_names_are_the_phylip_loaders():
    from ccphylo_tpu_torch.io.phylip import PhylipStream
    n = 40
    specs = collection.name_specs(n)
    text = f"{n}\n".encode() + b"".join(
        name + b"\t" + b"\t".join(b"1" for _ in range(i)) + b"\n"
        for i, (name, _) in enumerate(specs))
    loaded = PhylipStream(text).load()
    assert [(x.data, x.cap) for x in loaded[2][:n]] == specs


def test_pack2_positions():
    v = torch.tensor([[1] + [0] * 15, [0] * 15 + [3]], dtype=torch.uint8)
    w = collection.pack2(v)
    assert w.tolist() == [[1 << 30], [3]]
