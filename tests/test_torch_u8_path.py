"""`tree -m dnj -b` on u8 cells (ccphylo_tpu_torch): the Phylip loader's
u8 cells (`PhylipStream.load(u8_scale=)`, native and Python parsers),
the tree seam's u8 route (`cli/tree_cmd.py::_route`, `_dispatch_build`)
and the packed engine's row-block packing (`tree/packed_engine.py::
pack_cells`) against the float64 path they stand beside: the same
words, join records and Newick bytes, at ByteScale 1 and at a
non-dyadic one, on tie-heavy matrices; a missing cell keeps the float64
path and route; the CLI's bytes and its counter of host bytes a cell.
Each is also held against the JAX package on the same inputs: its
Phylip loader with its packed engine's rounding (floor(d ByteScale +
0.5), clipped to 255), its packed and host exact engines, its CLI.
Everything compared is an integer or bytes: tolerance 0."""

import io

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ccphylo_tpu.cli.tree_cmd as jax_tree_cmd
import ccphylo_tpu.io.phylip as jax_phylip
import ccphylo_tpu.tree.packed_engine as jpe
import ccphylo_tpu_torch.tree.packed_engine as tpe
from ccphylo_tpu.io.qseqs import Name as JaxName
from ccphylo_tpu.tree.exact import build_tree as jax_build_tree
from ccphylo_tpu_torch import native
from ccphylo_tpu_torch.cli import tree_cmd
from ccphylo_tpu_torch.io import phylip
from ccphylo_tpu_torch.io.qseqs import Name
from ccphylo_tpu_torch.tree.exact import build_tree
from ccphylo_tpu_torch.utils import timing

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CCPHYLO_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("CCPHYLO_TORCH_ENGINE", raising=False)


def _names(n):
    return [Name(b"t%04d" % i, 4 if i < 32 else 32) for i in range(n)]


def _jax_names(n):
    return [JaxName(b"t%04d" % i, 4 if i < 32 else 32) for i in range(n)]


def _jax_cells(flat, bs):
    """The JAX packed engine's rounding of loaded distances to u8."""
    return np.clip(np.floor(np.asarray(flat, np.float64) * bs + 0.5), 0,
                   255).astype(np.uint8)


def _flat(n, seed, top, frac=False):
    """Tie-heavy integer distances below `top` (or with fractions)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, top, n * (n - 1) // 2).astype(np.float64)
    return v + rng.integers(0, 4, v.shape) / 4 if frac else v


def _phy(flat, n, names=None) -> bytes:
    out = io.BytesIO()
    phylip.print_phy(out, n, flat, names or [b"t%04d" % i for i in range(n)])
    return out.getvalue()


def _tril_square(q, n):
    """The engine's byte matrix by index scatter (the float64 path's
    former construction)."""
    npad = tpe.pad_packed(n)
    D = np.zeros((npad, npad), np.uint8)
    iu = np.tril_indices(n, -1)
    D[iu] = q
    D[(iu[1], iu[0])] = q
    return D


@pytest.mark.parametrize("n", [2, 3, 4, 300, 511, 513, 1100])
def test_pack_cells_is_the_symmetric_byte_matrix(n):
    q = np.random.default_rng(n).integers(0, 256, n * (n - 1) // 2) \
        .astype(np.uint8)
    words = tpe.pack_cells(q, n, "cpu")
    assert words.dtype == torch.int32
    assert np.array_equal(words.view(torch.uint8).numpy(), _tril_square(q, n))


def test_pack_cells_refuses_other_cells():
    with pytest.raises(ValueError):
        tpe.pack_cells(np.zeros(6, np.float64), 4, "cpu")
    with pytest.raises(ValueError):
        tpe.pack_cells(np.zeros(5, np.uint8), 4, "cpu")


def _records(monkeypatch):
    """Every dnj_joins_packed call's records, as numpy."""
    seen = []
    real = tpe.dnj_joins_packed

    def spy(words, m, **kw):
        out = real(words, m, **kw)
        seen.append([np.asarray(x.numpy() if torch.is_tensor(x) else x)
                     .copy() for x in out[:6]])
        return out
    monkeypatch.setattr(tpe, "dnj_joins_packed", spy)
    return seen


@pytest.mark.parametrize("bs", [1.0, 3.0])
@pytest.mark.parametrize("n,top,frac", [(3, 4, False), (4, 3, False),
                                        (300, 6, False), (300, 40, True),
                                        (700, 5, False)])
def test_u8_cells_build_the_float64_paths_tree(monkeypatch, n, top, frac,
                                               bs):
    flat = _flat(n, n + top, top, frac)
    q = phylip.dtouc_cells(flat, bs)
    seen = _records(monkeypatch)
    via_f64 = tree_cmd._dispatch_build(flat, n, _names(n), "dnj", 0, 9, "b",
                                       bs)
    assert tree_cmd._dispatch_build.last_engine == "packed"
    assert set(tpe.build_tree_packed.last_times) == {
        "quantize", "engine", "limbs", "newick"}
    via_u8 = tree_cmd._dispatch_build(q, n, _names(n), "dnj", 0, 9, "b", bs)
    assert tree_cmd._dispatch_build.last_engine == "packed"
    assert set(tpe.build_tree_packed.last_times) == {
        "pack", "engine", "limbs", "newick"}
    assert via_u8 == via_f64
    a, b = seen
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert np.array_equal(q, _jax_cells(flat, bs))
    assert via_u8 == jpe.build_tree_jax_packed(flat.copy(), n,
                                               _jax_names(n), bytescale=bs)
    if bs == 1.0:
        assert via_u8 == jax_build_tree(flat.copy(), n, _jax_names(n),
                                        "dnj", 0, 9, "b", bs)
    if bs == 1.0 and not frac:
        assert via_u8 == build_tree(flat.copy(), n, _names(n), "dnj", 0, 9,
                                    "b", bs)


def test_route_of_u8_cells(monkeypatch):
    q = np.zeros(6, np.uint8)
    assert tree_cmd._route(q, "dnj", "b", 1.0)[0] == "packed"
    monkeypatch.setenv("CCPHYLO_TORCH_ENGINE", "exact")
    assert tree_cmd._route(q, "dnj", "b", 1.0)[0] == "exact"
    with pytest.raises(ValueError, match="packed route only"):
        tree_cmd._dispatch_build(q, 4, _names(4), "dnj", 0, 9, "b", 1.0)


_CELLS = (b"0", b"2.5", b"3.4999", b"254.5", b"255.49", b"300", b"1e2",
          b"-0", b"7.25", b"0.125", b"1.5E1", b"12")


def _cells_phy(n, seed, extra=None):
    rng = np.random.default_rng(seed)
    rows = [b"%10d" % n]
    for i in range(n):
        toks = [_CELLS[k] for k in rng.integers(0, len(_CELLS), i)]
        if extra is not None and i == n - 1:
            toks[extra[0]] = extra[1]
        rows.append(b"\t".join([b"s%d" % i] + toks))
    return b"\n".join(rows) + b"\n"


@pytest.mark.parametrize("bs", [1.0, 0.7, 3.0])
@pytest.mark.parametrize("parser", ["native", "python"])
def test_loader_hands_dtouc_cells(bs, parser):
    """The u8 cells equal dtouc_cells of the float64 load, byte for byte,
    from either parser: halves, clipping at 255, exponents, -0."""
    if parser == "native" and not native.available():
        pytest.skip("native library unavailable")
    data = _cells_phy(60, 3)
    st = phylip.PhylipStream(data)
    if parser == "python":
        st._load_native = lambda *a, **k: None
    n, cells, names, _ = st.load(u8_scale=bs)
    n2, flat, names2, _ = phylip.PhylipStream(data).load()
    assert cells.dtype == np.uint8 and flat.dtype == np.float64
    assert np.array_equal(cells, phylip.dtouc_cells(flat, bs))
    n3, jflat, jnames, _ = jax_phylip.PhylipStream(data).load()
    assert n3 == n and np.array_equal(cells, _jax_cells(jflat, bs))
    assert [x.data for x in names[:n]] == [x.data for x in jnames[:n3]]
    assert [x.data for x in names[:n]] == [x.data for x in names2[:n2]]
    assert [x.cap for x in names[:n]] == [x.cap for x in names2[:n2]]


@pytest.mark.parametrize("bad", [b"-1", b"nan", b"-0.5"])
@pytest.mark.parametrize("parser", ["native", "python"])
def test_a_missing_cell_keeps_float64(bad, parser):
    if parser == "native" and not native.available():
        pytest.skip("native library unavailable")
    data = _cells_phy(40, 4, extra=(5, bad))
    st = phylip.PhylipStream(data)
    if parser == "python":
        st._load_native = lambda *a, **k: None
    n, flat, _, _ = st.load(u8_scale=1.0)
    want = phylip.PhylipStream(data).load()[1]
    assert flat.dtype == np.float64
    assert np.array_equal(flat, want, equal_nan=True)
    assert np.array_equal(flat, jax_phylip.PhylipStream(data).load()[1],
                          equal_nan=True)
    assert st.pos == len(data)
    if bad != b"nan":
        assert tree_cmd._route(flat, "dnj", "b", 1.0)[0] == "exact"


def test_small_matrices_and_other_scales_load_float64():
    data = _cells_phy(2, 1) + _cells_phy(5, 2)
    st = phylip.PhylipStream(data)
    assert st.load(u8_scale=1.0)[1].dtype == np.float64     # n = 2
    assert st.load(u8_scale=1.0)[1].dtype == np.uint8
    for bs in (0.0, -1.0, float("inf"), float("nan"), None):
        assert phylip.PhylipStream(_cells_phy(5, 2)).load(u8_scale=bs)[1] \
            .dtype == np.float64


def _cli(tmp_path, phy: bytes, *args, main=tree_cmd.main_tree) -> bytes:
    src = tmp_path / "d.phy"
    src.write_bytes(phy)
    out = tmp_path / "t.nwck"
    assert main(["-i", str(src), "-o", str(out), *args]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("args,cells", [(("-m", "dnj", "-b"), 1),
                                        (("-m", "dnj", "-b", "4"), 1),
                                        (("-m", "nj", "-b"), 8),
                                        (("-m", "dnj"), 8)])
def test_cli_bytes_and_host_bytes_a_cell(tmp_path, monkeypatch, args,
                                         cells):
    """Two matrices in one file (names carried across), through the CLI:
    the bytes of the float64 load and of the JAX package's CLI, and one
    byte a cell held under -b."""
    n = 120
    phy = _phy(_flat(n, 1, 7), n) + _phy(_flat(n, 2, 9, frac=True), n)
    monkeypatch.setattr(timing, "_spans", {})
    monkeypatch.setattr(timing, "_counters", {})
    with profile(activities=[ProfilerActivity.CPU]):
        got = _cli(tmp_path, phy, *args)
    assert timing.counters()["tree/host_cell_bytes"] \
        == cells * 2 * n * (n - 1) // 2
    real = phylip.PhylipStream.load
    monkeypatch.setattr(phylip.PhylipStream, "load",
                        lambda self, u8_scale=None: real(self))
    assert got == _cli(tmp_path, phy, *args)
    assert got == _cli(tmp_path, phy, *args, main=jax_tree_cmd.main_tree)
    monkeypatch.setenv("CCPHYLO_TORCH_ENGINE", "exact")
    if cells == 1:
        assert got == _cli(tmp_path, phy, *args)
