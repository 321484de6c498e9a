"""The port's count-matrix distances (ops/matdist_torch.py) on CPU
tensors against the JAX package's ops/matdist_jax.py and the port's
host metrics (ops/veccmp.cmp_mats), on the same seeded samples.

Tolerances.  `R` (rows_inc) is exact everywhere.  In float32 `S` is
held to rel 2e-5 / abs 2e-5 of the JAX table: both sum float32 values
in their own order, and that is the tolerance the JAX package's own
test allows against the host.  In float64 `S` is held to rel 1e-12 of
the host's sequential sum (same per-position expressions, another
order of summation), and bit for bit for the metrics whose
per-position values are integers (`EXACT_METRICS`)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ccphylo_tpu.ops import matdist_jax  # noqa: E402
from ccphylo_tpu_torch.ops import matdist_torch as mt  # noqa: E402
from ccphylo_tpu_torch.ops.veccmp import (cmp_mats, get_veccmp,  # noqa: E402
                                          p_chisqr)

torch.set_num_threads(1)

TABLE = sorted(mt.METRICS)
FAMILIES = ["z", "l3", "nl3", "l4"]
MIN_DEPTH = 15


def _samples(k=7, L=900, seed=0):
    """The sample maker of tests/test_matdist_jax.py."""
    rng = np.random.RandomState(seed)
    counts, totals = [], []
    for i in range(k):
        Li = L - rng.randint(0, 60)
        c = rng.randint(0, 60, (Li, 6)).astype(np.uint16)
        # sprinkle shallow and all-zero positions to hit the gates
        z = rng.rand(Li) < 0.08
        c[z] = 0
        shallow = rng.rand(Li) < 0.1
        c[shallow] //= 20
        counts.append(c)
        totals.append(c.astype(np.int64).sum(axis=1))
    return counts, totals


def _host_table(method, counts, totals):
    """{(i, j): (dist, rows_inc)} of cmp_mats for every ordered pair it
    scores."""
    veccmp = get_veccmp(method, 0.05)
    out = {}
    for i in range(len(counts)):
        for j in range(len(counts)):
            if i == j or len(counts[j]) > len(counts[i]):
                continue
            dist, rinc = cmp_mats(counts[i], totals[i], counts[j],
                                  totals[j], 0, MIN_DEPTH, 1, 0.0, veccmp)
            if dist not in (-1.0, -2.0):
                out[i, j] = (dist, rinc)
    return out


def test_metric_tables_are_the_references():
    assert sorted(mt.METRICS) == sorted(matdist_jax.METRICS)
    assert len(mt.METRICS) == 15


@pytest.mark.parametrize("method", TABLE + FAMILIES)
def test_float32_table_matches_jax(method):
    counts, totals = _samples(seed=4 if method in FAMILIES else 0)
    spec = mt.resolve_metric(method, 0.05)
    assert spec == matdist_jax.resolve_metric(method, 0.05)
    Sj, Rj = matdist_jax.pair_table(spec, counts, totals, MIN_DEPTH)
    S, R = mt.pair_table(spec, counts, totals, MIN_DEPTH, device="cpu",
                         dtype=torch.float32)
    assert S.dtype == np.float64 and R.dtype == np.int64
    off = ~np.eye(len(counts), dtype=bool)
    np.testing.assert_array_equal(R[off], Rj[off])
    np.testing.assert_allclose(S[off], Sj[off], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("method", TABLE + FAMILIES)
def test_float64_table_matches_host(method, monkeypatch):
    counts, totals = _samples(seed=4 if method in FAMILIES else 0)
    spec = mt.resolve_metric(method, 0.05)
    # two position chunks and four row blocks: both loops are crossed
    monkeypatch.setattr(mt, "_block_shape", lambda *a: (2, 512))
    S, R = mt.pair_table(spec, counts, totals, MIN_DEPTH, device="cpu")
    assert mt.pair_table.last["chunks"] == 2
    host = _host_table(method, counts, totals)
    # z passes few columns of this uniform data: some pairs score nothing
    assert len(host) >= (5 if method == "z" else 21)
    for i in range(len(counts)):
        for j in range(len(counts)):
            if i != j and len(counts[j]) <= len(counts[i]) \
                    and (i, j) not in host:
                assert int(R[i, j]) == 0  # cmp_mats' "no overlap"
    for (i, j), (dist, rinc) in host.items():
        assert int(R[i, j]) == rinc, (method, i, j)
        if method in mt.EXACT_METRICS:
            assert float(S[i, j]) == dist, (method, i, j)
        else:
            assert float(S[i, j]) == pytest.approx(dist, rel=1e-12,
                                                   abs=1e-12)


def test_which_metrics_are_byte_equal_on_cpu_tensors(record_property):
    """Records, per metric, whether the float64 table on CPU tensors is
    bit-equal to the host's sequential sums; only the integer-valued
    metrics are promised (torch sums in another order)."""
    counts, totals = _samples()
    equal = {}
    for method in TABLE + FAMILIES:
        spec = mt.resolve_metric(method, 0.05)
        S, _ = mt.pair_table(spec, counts, totals, MIN_DEPTH, device="cpu")
        host = _host_table(method, counts, totals)
        equal[method] = all(float(S[i, j]) == d
                            for (i, j), (d, _) in host.items())
    record_property("byte_equal_float64_cpu", sorted(
        m for m, e in equal.items() if e))
    print("byte-equal to the host in float64 on CPU tensors:",
          sorted(m for m, e in equal.items() if e))
    assert all(equal[m] for m in mt.EXACT_METRICS), equal


def test_lower_triangle_only(monkeypatch):
    counts, totals = _samples(k=5, L=300, seed=2)
    S, R = mt.pair_table("chi2", counts, totals, MIN_DEPTH, device="cpu")
    # one row per block: the narrowest lower blocks
    monkeypatch.setattr(mt, "_block_shape", lambda *a: (1, mt.PCHUNK))
    Sl, Rl = mt.pair_table("chi2", counts, totals, MIN_DEPTH, device="cpu",
                           lower=True)
    low = np.tril(np.ones((5, 5), bool), -1)
    np.testing.assert_array_equal(Rl[low], R[low])
    np.testing.assert_array_equal(Sl[low], S[low])
    assert not Rl[np.triu(np.ones((5, 5), bool), 1)].any()


def test_block_shape_follows_the_budget(monkeypatch):
    """Rows per block while a row fits the budget; below that one row
    and a shorter position chunk, so that many samples cannot outgrow
    the memory."""
    cpu = torch.device("cpu")
    row = 7 * 5 * 8 * 900  # one sample row against k = 7 at L = 900
    for budget, want in ((10 * row, (7, 900)), (3 * row + 5, (3, 900)),
                         (row, (1, 900)), (row // 3, (1, 300)),
                         (1, (1, 1))):
        monkeypatch.setattr(mt, "_budget_bytes", lambda dev, b=budget: b)
        assert mt._block_shape(7, 900, torch.float64, cpu) == want
    monkeypatch.setattr(mt, "_budget_bytes", lambda dev: row)
    assert mt._block_shape(7, 900, torch.float32, cpu) == (2, 900)
    assert mt._block_shape(7, 10 ** 6, torch.float64, cpu) \
        == (1, row // (7 * 5 * 8))


@pytest.mark.parametrize("method", ["l1", "chi2"])
def test_budget_below_one_row_shortens_the_chunk(method, monkeypatch):
    counts, totals = _samples()
    S0, R0 = mt.pair_table(method, counts, totals, MIN_DEPTH, device="cpu")
    assert mt.pair_table.last["chunks"] == 1
    # a budget of 100 positions of one sample row
    monkeypatch.setattr(mt, "_budget_bytes", lambda dev: 7 * 5 * 8 * 100)
    S, R = mt.pair_table(method, counts, totals, MIN_DEPTH, device="cpu")
    last = mt.pair_table.last
    assert last["block_rows"] == 1 and last["chunks"] == 9
    np.testing.assert_array_equal(R, R0)
    if method in mt.EXACT_METRICS:
        np.testing.assert_array_equal(S, S0)
    else:
        np.testing.assert_allclose(S, S0, rtol=1e-12, atol=1e-12)


def test_resolve_metric_rejects_unknown():
    assert mt.resolve_metric("bogus", 0.05) is None
    assert mt.resolve_metric("lx", 0.05) is None
    assert mt.resolve_metric("z", 0.01) == "z@0.01"
    assert mt.cos_pair_table is not None


def test_sentinel_logic_matches_host():
    counts, totals = _samples(k=5, L=400, seed=3)
    min_depth, min_length, min_cov, norm = 15, 30, 0.5, 1000000
    S, R = mt.cos_pair_table(counts, totals, min_depth, device="cpu")
    veccmp = get_veccmp("cos")
    nnucs = [(t >= min_depth).sum() for t in totals]
    seen = set()
    for min_length in (30, 330, 10 ** 6):
        for i in range(5):
            for j in range(5):
                if i == j:
                    continue
                want = cmp_mats(counts[i], totals[i], counts[j], totals[j],
                                norm, min_depth, min_length, min_cov, veccmp)
                got = mt.cmp_mats_from_table(
                    S, R, i, j, len(counts[i]), len(counts[j]),
                    int(nnucs[j]), norm, min_depth, min_length, min_cov)
                if len(counts[j]) > len(counts[i]):
                    assert got == (-1.0, 0) and want[0] == -1.0
                    seen.add("longer")
                    continue
                assert got[1] == want[1]
                if want[0] in (-1.0, -2.0):
                    assert got[0] == want[0]
                    seen.add(want[0])
                else:
                    assert got[0] == pytest.approx(want[0], rel=1e-12)
                    seen.add("scored")
    assert seen == {"longer", -1.0, -2.0, "scored"}


def test_z_gate_equals_host_on_every_small_column():
    """z's gate p_chisqr(q) <= alpha for every column (total t, majority
    count mx) with t <= 400, the borderline ones among them, at three
    alphas: torch.erf on CPU tensors decides as scipy's does."""
    t = np.arange(1, 401)
    T, M = np.meshgrid(t, np.arange(0, 401), indexing="ij")
    keep = M <= T
    T, M = T[keep].astype(np.float64), M[keep].astype(np.float64)
    q = (T - 2 * M) ** 2 / T
    ph = p_chisqr(q)
    pt = mt._p_chisqr(torch.from_numpy(q)).numpy()
    for alpha in (0.05, 0.01, 0.001):
        np.testing.assert_array_equal(pt <= alpha, ph <= alpha)
    # 1 - erf(..) cancels: an ulp of 1, not of p
    np.testing.assert_allclose(pt, ph, rtol=0, atol=4e-16)


def test_default_device_is_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("CCPHYLO_TORCH_DEVICE", raising=False)
    counts, totals = _samples(k=3, L=100)
    with pytest.raises(RuntimeError, match="cuda"):
        mt.pair_table("l1", counts, totals, MIN_DEPTH)
