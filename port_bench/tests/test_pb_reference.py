"""The plain references against the program's CPU path at tiny sizes,
and the controls one precision lower against the references."""

import numpy as np
import pytest
import torch

from port_bench.gen import collection
from port_bench.reference import dnj, snp
from port_bench.tests.conftest import tiny_config

SEED = 1_618_033_988_749


def _names(specs, cls):
    return [cls(d, c) for d, c in specs]


@pytest.mark.parametrize("dtype,engine", [("d", "float64"), ("b", "packed")])
@pytest.mark.parametrize("name,k", [("tiny", 0), ("tiny", 1), ("tiny", 2)])
def test_dnj_equals_the_programs_cpu_path(monkeypatch, dtype, engine, name,
                                          k):
    from ccphylo_tpu_torch.cli import tree_cmd
    from ccphylo_tpu_torch.io.qseqs import Name
    monkeypatch.setenv("CCPHYLO_TORCH_DEVICE", "cpu")
    cfg = tiny_config(name)
    n = cfg["n"]
    flat = collection.distances(cfg, SEED, k, "cpu")
    specs = collection.name_specs(n)
    got = tree_cmd._dispatch_build(flat, n, _names(specs, Name), "dnj", 0,
                                   9, dtype, 1.0)
    assert tree_cmd._dispatch_build.last_engine == engine
    assert dnj.newick(flat, n, _names(specs, dnj.RefName), dtype) == got
    low = dict(qmax=15) if dtype == "b" else dict(ftype=np.float32)
    assert dnj.newick(flat, n, _names(specs, dnj.RefName), dtype,
                      **low) != got


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dnj_equals_the_host_engine_with_ties(seed):
    """Small integer distances with many ties, both cell types."""
    from ccphylo_tpu_torch.io.qseqs import Name
    from ccphylo_tpu_torch.tree.exact import build_tree
    rng = np.random.default_rng(seed)
    for n in (3, 4, 9, 40):
        flat = rng.integers(0, 6, n * (n - 1) // 2).astype(np.float64)
        specs = collection.name_specs(n)
        for dtype in ("d", "b"):
            want = build_tree(flat.copy(), n, _names(specs, Name), "dnj", 0,
                              9, dtype, 1.0)
            assert dnj.newick(flat, n, _names(specs, dnj.RefName),
                              dtype) == want


def test_snp_counts_equal_the_programs_cpu_path(monkeypatch):
    from ccphylo_tpu_torch.cli import dist_cmd
    monkeypatch.setenv("CCPHYLO_TORCH_DEVICE", "cpu")
    cfg = tiny_config("tiny")
    seqs, inc = collection.alignment(cfg, SEED, 0, "cpu")
    n = cfg["n"]
    got = dist_cmd._batch_shared(list(seqs), list(range(n)), inc)
    want = snp.counts(seqs, inc, "cpu", words=64)
    assert np.array_equal(got, want)
    assert want.max() > 0
    low = snp.counts(seqs, inc, "cpu", dtype=torch.bfloat16, words=64)
    assert not np.array_equal(low, want)
