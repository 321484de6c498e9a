"""The port's own copies of the host modules (ccphylo_tpu_torch/io, native,
ops/pack2bit.py, ops/snp.py, ops/veccmp.py, ops/distcmp.py,
utils/checkpoint.py, tree/newick_build.py, tree/exact.py,
schedule/makespan.py, cli/args.py and the twelve host subcommands'
cli/*_cmd.py) against their originals in ccphylo_tpu, on the same
numpy-seeded inputs.  The copies
compute what the originals compute, so every comparison is of bytes,
integers or identical float64 values: tolerance 0."""

import ast
import gzip
import io

import numpy as np
import pytest

import ccphylo_tpu.cli.args as r_args
import ccphylo_tpu.cli.makespan_cmd as r_mkcmd
import ccphylo_tpu.io.hashmapstr as r_hmap
import ccphylo_tpu.io.kmadb as r_kmadb
import ccphylo_tpu.io.newick_parse as r_nwp
import ccphylo_tpu.io.tsv as r_tsv
import ccphylo_tpu.ops.distcmp as r_dcmp
import ccphylo_tpu.schedule.makespan as r_mk
import ccphylo_tpu.io.fileio as r_fileio
import ccphylo_tpu.io.kma as r_kma
import ccphylo_tpu.io.phylip as r_phylip
import ccphylo_tpu.io.qseqs as r_qseqs
import ccphylo_tpu.native as r_native
import ccphylo_tpu.ops.pack2bit as r_pack
import ccphylo_tpu.ops.snp as r_snp
import ccphylo_tpu.ops.veccmp as r_vec
import ccphylo_tpu.tree.exact as r_exact
import ccphylo_tpu.tree.newick_build as r_nwk
import ccphylo_tpu.utils.checkpoint as r_ckpt
import ccphylo_tpu_torch.cli.args as p_args
import ccphylo_tpu_torch.cli.makespan_cmd as p_mkcmd
import ccphylo_tpu_torch.io.hashmapstr as p_hmap
import ccphylo_tpu_torch.io.kmadb as p_kmadb
import ccphylo_tpu_torch.io.newick_parse as p_nwp
import ccphylo_tpu_torch.io.tsv as p_tsv
import ccphylo_tpu_torch.ops.distcmp as p_dcmp
import ccphylo_tpu_torch.schedule.makespan as p_mk
import ccphylo_tpu_torch.io.fileio as p_fileio
import ccphylo_tpu_torch.io.kma as p_kma
import ccphylo_tpu_torch.io.phylip as p_phylip
import ccphylo_tpu_torch.io.qseqs as p_qseqs
import ccphylo_tpu_torch.native as p_native
import ccphylo_tpu_torch.ops.pack2bit as p_pack
import ccphylo_tpu_torch.ops.snp as p_snp
import ccphylo_tpu_torch.ops.veccmp as p_vec
import ccphylo_tpu_torch.tree.exact as p_exact
import ccphylo_tpu_torch.tree.newick_build as p_nwk
import ccphylo_tpu_torch.utils.checkpoint as p_ckpt

from .conftest import REPO
from .gen_kma_data import make_dataset
from .test_sched_misc_parity import _write_kma_db


def _same(a, b):
    """Equal structures of arrays, scalars, bytes, tuples and lists."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b))


def _no_native(monkeypatch):
    """Force the pure-Python paths of both packages."""
    for nat in (r_native, p_native):
        monkeypatch.setattr(nat, "_lib", None)
        monkeypatch.setattr(nat, "_tried", True)


# ---------------------------------------------------------------------
# ops/pack2bit.py


def _codes(rng, length, p4=0.05, p16=0.1):
    c = rng.integers(0, 4, length).astype(np.uint8)
    c[rng.random(length) < p4] = 4
    c[rng.random(length) < p16] |= 16
    return c


def _pack_case(name, m):
    rng = np.random.default_rng(sum(map(ord, name)))
    L = 1000
    if name == "get_2bit_table":
        return [m.get_2bit_table(f) for f in (0, 8, 16, 25)]
    if name == "get_iupac_bit_table":
        return [m.get_iupac_bit_table(f) for f in (0, 1)]
    if name == "translate_pack_unpack":
        raw = bytes(rng.choice(list(b"ACGTNacgtn-RX\n "), L))
        out = []
        for f in (0, 8):
            codes = m.translate(raw, m.get_2bit_table(f))
            words, ns = m.pack_2bit(codes)
            out += [codes, words, ns, m.unpack_2bit(words, len(codes))]
        return out
    if name == "init_inc_pos":
        return [m.init_inc_pos(n) for n in (1, 31, 32, 33, 1000)] \
            + [m.n_words(n) for n in (0, 1, 32, 33)]
    if name == "mask_words":
        bits = rng.random(L) < 0.7
        w = m.bits_to_mask_words(bits)
        return [w, m.mask_words_to_bits(w, L)]
    if name.startswith("get_inc_pos"):
        variant = name.split(":")[1]
        out = []
        for proxi in (0, 5):
            seq, ref = _codes(rng, L), _codes(rng, L)
            inc = m.init_inc_pos(L)
            m.get_inc_pos(inc, seq, ref, proxi, variant)
            out += [inc, seq, ref]
        return out
    if name == "meth_motifs":
        motifs = m.parse_meth_motifs(b">m1\nGAtC\n>m2\nCCwGG\n>m3\nrAy\n")
        codes = rng.integers(0, 4, L).astype(np.uint8)
        packed, _ = m.pack_2bit(codes)
        inc = m.init_inc_pos(L)
        n = m.mask_motifs(packed, inc, L, motifs)
        return [[list(x) for x in motifs], inc, n]
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "get_2bit_table", "get_iupac_bit_table", "translate_pack_unpack",
    "init_inc_pos", "mask_words", "get_inc_pos:default",
    "get_inc_pos:insig", "get_inc_pos:insigprune", "meth_motifs"])
def test_pack2bit(name):
    _same(_pack_case(name, p_pack), _pack_case(name, r_pack))


# ---------------------------------------------------------------------
# ops/snp.py


def _snp_inputs(rng, n, L):
    W = (L + 31) // 32
    seqs = rng.integers(0, 2 ** 64, (n, W), dtype=np.uint64)
    seqs[1:] = seqs[0]  # near-identical samples with scattered SNPs
    flips = rng.random((n, W)) < 0.2
    seqs[flips] ^= np.uint64(3) << (rng.integers(0, 32, int(flips.sum()))
                                    .astype(np.uint64) * np.uint64(2))
    incs = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32) \
        | rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    return seqs, incs


def _snp_case(name, m):
    rng = np.random.default_rng(sum(map(ord, name)))
    L = 32 * 40
    seqs, incs = _snp_inputs(rng, 70 if name.startswith("pairwise") else 6,
                             L)
    s1, s2, i1, i2 = seqs[0], seqs[1], incs[0], incs[1]
    if name == "expand_bits":
        return m.expand_bits(incs)
    if name == "diff_pairs":
        return m.diff_pairs(s1, s2)
    if name == "get_npos":
        return m.get_npos(i1)
    if name == "fsacmp":
        return m.fsacmp(s1, s2, i1)
    if name == "fsacmpair":
        return m.fsacmpair(s1, s2, i1 & i2)
    if name == "mask_proxi":
        return [m.mask_proxi(i1, i2, s1, s2, L, p) for p in (0, 3, 40)]
    if name == "diff_positions":
        return [tuple(x) for x in m.diff_positions(s1, s2, i1, L)]
    if name == "pairwise_masked":
        return m.pairwise_masked(seqs, incs)
    if name == "pairwise_shared":
        return m.pairwise_shared(seqs, i1)
    if name == "cross_block":
        return m.cross_block(seqs[:3], seqs, i1)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "expand_bits", "diff_pairs", "get_npos", "fsacmp", "fsacmpair",
    "mask_proxi", "diff_positions", "pairwise_masked", "pairwise_shared",
    "cross_block"])
def test_snp(name):
    _same(_snp_case(name, p_snp), _snp_case(name, r_snp))


# ---------------------------------------------------------------------
# ops/veccmp.py

_METRICS = ["cos", "z", "chi2", "nchi2", "nc", "c", "np", "p", "nbc", "bc",
            "nl1", "nl2", "nlinf", "l1", "l2", "linf", "l3", "nl3"]


@pytest.mark.parametrize("metric", _METRICS)
def test_veccmp(metric):
    rng = np.random.default_rng(_METRICS.index(metric))
    rows = 300
    c1 = rng.poisson(8, (rows, 6)).astype(np.int64)
    c2 = c1 + rng.integers(-2, 3, (rows, 6))
    c2[c2 < 0] = 0
    t1, t2 = c1.sum(axis=1), c2.sum(axis=1)
    outs = []
    for m in (p_vec, r_vec):
        fn = m.get_veccmp(metric)
        outs.append([np.asarray(fn(c1, c2, t1, t2)),
                     m.cmp_mats(c1, t1, c2, t2, 1000, 5, 10, 0.1, fn),
                     m.cmp_mats(c1[:50], t1[:50], c2, t2, 0, 5, 10, 0.1,
                                fn)])
    _same(*outs)
    assert p_vec.get_veccmp("nope") is None


# ---------------------------------------------------------------------
# native/ and io/phylip.py, io/kma.py: native and pure-Python paths


def test_native_library_builds_into_the_build_directory():
    assert p_native.available() == r_native.available()
    if p_native.available():
        import os
        path = p_native.get_lib()._name
        assert os.path.basename(os.path.dirname(path)) == "_build"
        assert "ccphylo_tpu_torch" in path


def _phy_text(rng, n, missing):
    flat = np.round(rng.uniform(0, 50, n * (n - 1) // 2), 3)
    if missing:
        flat[rng.random(len(flat)) < 0.1] = -1.0
    names = [b"dir/sample_%03d.fsa" % i for i in range(n)]
    return flat, names


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("case", [
    "print_phy:1", "print_phy:0", "print_phy:5", "print_phy:include",
    "print_full_phy", "print_phy_update", "load_phy", "load_phy:missing",
    "stream_two_matrices", "size_and_filenames", "fmt_precision"])
def test_phylip(case, path, tmp_path, monkeypatch):
    if path == "python":
        _no_native(monkeypatch)
    elif not (p_native.available() and r_native.available()):
        pytest.skip("no C++ toolchain for the native library")
    rng = np.random.default_rng(sum(map(ord, case)))
    n = 9
    flat, names = _phy_text(rng, n, "missing" in case)
    new_row = rng.uniform(0, 9, n)
    outs = []
    for m, q in ((p_phylip, p_qseqs), (r_phylip, r_qseqs)):
        buf = io.BytesIO()
        if case.startswith("print_phy:"):
            arg = case.split(":")[1]
            if arg == "include":
                inc = [1, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1]
                m.print_phy(buf, n, flat, names + names[:3], 1, 9, inc)
            else:
                m.print_phy(buf, n, flat, names, int(arg), 6, None, b"tpl")
            outs.append(buf.getvalue())
        elif case == "print_full_phy":
            m.print_full_phy(buf, n, flat, names, 1, 4)
            outs.append(buf.getvalue())
        elif case == "fmt_precision":
            vals = np.array([0.0, 1.5, 1e-7, 123456.789, -1.0, 1e12])
            outs.append([m._fmt_cells(vals, p) for p in (0, 3, 9, 15)])
        elif case == "print_phy_update":
            f = tmp_path / f"u_{m.__name__}.phy"
            m.print_phy(buf, n, flat, names, 5, 9, None, b"tpl")
            f.write_bytes(buf.getvalue())
            m.print_phy_update(str(f), n + 1, b"new/sample.fsa", new_row,
                               5, 9)
            outs.append(f.read_bytes())
        else:
            m.print_phy(buf, n, flat, names, 1, 9)
            data = buf.getvalue()
            if case == "stream_two_matrices":
                data = b"#first\n" + data + data
                st = m.PhylipStream(data)
                got = []
                for _ in range(3):
                    ld = st.load()
                    if ld is None:
                        got.append(None)
                        continue
                    k, fl, nm, header = ld
                    got.append([k, np.array(fl), [bytes(x) for x in nm],
                                header])
                outs.append(got)
            elif case == "size_and_filenames":
                k, pos = m.get_size_phy(data)
                outs.append([k, pos, m.get_filenames_phy(data, pos, k,
                                                         b"p/")])
            else:
                k, fl, nm, header = m.load_phy(data)
                assert isinstance(nm[0], q.Name)
                outs.append([k, np.array(fl), [bytes(x) for x in nm],
                             [x.cap for x in nm]])
    _same(*outs)


@pytest.fixture(scope="module")
def kma_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kma_host")
    make_dataset(d, n_samples=4, length=300)
    return d


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("what", ["mat", "fsa", "fasta_pack"])
def test_kma_loading(what, path, kma_dir, monkeypatch):
    if path == "python":
        _no_native(monkeypatch)
    elif not (p_native.available() and r_native.available()):
        pytest.skip("no C++ toolchain for the native library")
    outs = []
    for kma, pack, fio in ((p_kma, p_pack, p_fileio),
                           (r_kma, r_pack, r_fileio)):
        got = []
        for s in range(4):
            if what == "mat":
                f = str(kma_dir / f"s{s:02d}.mat.gz")
                got.append(kma.mat_template_names(f))
                for t in (b"tpl1", b"tpl2", b"absent"):
                    tm = kma.load_mat_template(f, t)
                    if tm is None:
                        got.append(None)
                        continue
                    st = tm.stripped()
                    got.append([tm.length, tm.n_nucs(10),
                                np.array(tm.counts), np.array(tm.totals),
                                st.length, np.array(st.counts)])
            else:
                data = fio.read_bytes(str(kma_dir / f"s{s:02d}.fsa.gz"))
                if what == "fsa":
                    got.append([(h, raw) for h, raw in kma.iter_fasta(data)])
                for flag in (0, 8):
                    table = pack.get_2bit_table(flag)
                    codes = kma.load_fasta_seq(data, b"tpl1", table)
                    got.append([codes, pack.pack_2bit(codes)])
                got.append(kma.load_fasta_seq(data, b"absent", table))
        outs.append(got)
    _same(*outs)


# ---------------------------------------------------------------------
# tree/exact.py, tree/newick_build.py, io/qseqs.py


def _names(q, n):
    return [q.Name(b"t%03d" % i, 32) for i in range(n)]


def _tree_input(method, dtype, missing):
    rng = np.random.default_rng(
        sorted(r_exact.METHODS).index(method) * 8 + "dfsb".index(dtype) * 2
        + missing)
    n = 24
    if dtype in "sb":
        # distances that quantize with ties at ByteScale 4
        flat = rng.integers(1, 60, n * (n - 1) // 2).astype(np.float64) / 4
    else:
        flat = rng.uniform(0.1, 20.0, n * (n - 1) // 2)
    if missing:
        flat[rng.random(len(flat)) < 0.08] = -1.0
    return n, flat


def test_methods_are_the_same_set():
    assert list(p_exact.METHODS) == list(r_exact.METHODS)


@pytest.mark.parametrize("missing", [0, 1])
@pytest.mark.parametrize("dtype", ["d", "f", "s", "b"])
@pytest.mark.parametrize("method", sorted(r_exact.METHODS))
def test_build_tree(method, dtype, missing):
    n, flat = _tree_input(method, dtype, missing)
    outs = []
    for ex, q in ((p_exact, p_qseqs), (r_exact, r_qseqs)):
        for flag, threads in ((0, 1), (3, 2)):
            outs.append(bytes(ex.build_tree(
                flat.copy(), n, _names(q, n), method, flag, 9, dtype, 4.0,
                threads)))
    assert outs[:2] == outs[2:]
    assert outs[0].startswith(b"(") and outs[0] != outs[1]


def test_newick_build_and_names():
    outs = []
    for nw, q in ((p_nwk, p_qseqs), (r_nwk, r_qseqs)):
        a, b, c = q.Name(b"alpha", 8), q.Name(b"b", 32), q.Name(b"c" * 40, 64)
        nw.form_node(a, b, 0.125, 2.5, 9)
        nw.form_node(c, a, -0.5, 1e-9, 4)
        nw.form_last_node(c, q.Name(b"d", 32), 3.0, 9)
        e = q.Name(b"e", 32)
        nw.form_last_bi_node(e, c, 0.75, 9)
        nw.byteshift_fix(e)
        outs.append([bytes(e.data), e.cap, len(e), repr(e), bytes(c.data)])
    _same(*outs)


# ---------------------------------------------------------------------
# io/fileio.py, utils/checkpoint.py, cli/args.py


def test_fileio(tmp_path):
    outs = []
    for fio in (p_fileio, r_fileio):
        plain = tmp_path / f"{fio.__name__}.txt"
        fh = fio.open_out(str(plain))
        fh.write(b"abc\n")
        fio.close_out(fh)
        gz = tmp_path / f"{fio.__name__}.gz"
        fh = fio.open_out_gz(str(gz))
        fh.write(b"xyz" * 100)
        fh.close()
        outs.append([fio.read_bytes(str(plain)), fio.read_bytes(str(gz)),
                     gzip.decompress(gz.read_bytes()),
                     fio.is_gz_name("a.gz"), fio.is_gz_name("a.txt")])
    _same(*outs)


def test_block_checkpoint_resumes(tmp_path):
    rng = np.random.default_rng(3)
    n = 50
    M = rng.integers(0, 99, (n, n))
    M = np.tril(M, -1) + np.tril(M, -1).T
    outs = []
    for ck in (p_ckpt, r_ckpt):
        d = str(tmp_path / ck.__name__)
        fp = ck.fingerprint_arrays([M, np.arange(3)])
        calls = []

        def compute(si, sj):
            calls.append((si.start, sj.start))
            return M[si, sj]

        first = ck.BlockCheckpoint(d, n, fp, block=16).fill(compute)
        ncalls = len(calls)
        again = ck.BlockCheckpoint(d, n, fp, block=16).fill(compute)
        assert len(calls) == ncalls  # every tile came from the store
        other = ck.BlockCheckpoint(d, n, "other", block=16).fill(compute)
        assert len(calls) == 2 * ncalls  # a new fingerprint recomputes
        outs.append([fp, first, again, other, ncalls])
    _same(*outs)
    np.testing.assert_array_equal(outs[0][1], M)


def test_args(capsys):
    outs = []
    for m in (p_args, r_args):
        a = m.Args(["-x", "7", "-S", "\\t", "-b", "2.5", "-q", "q", "-b",
                    "file"])
        got = [a.next_num("x")]
        a.i += 1
        got.append(a.next_char("S"))
        a.i += 1
        got.append(a.opt_float(1.0))
        a.i += 1
        got.append(a.next_char("q"))
        a.i += 1
        got.append(a.opt_float(1.0))  # "file" is no number: default
        a.i = len(a.argv) - 1
        with pytest.raises(SystemExit) as exc:
            a.next_value("i")
        got += [exc.value.code, capsys.readouterr().err]
        outs.append(got)
    _same(*outs)


# ---------------------------------------------------------------------
# the host subcommands' modules: copies that differ only in docstrings

_COPIES = ["io/tsv.py", "io/newick_parse.py", "io/hashmapstr.py",
           "io/kmadb.py", "ops/distcmp.py", "schedule/makespan.py"] + [
    f"cli/{c}_cmd.py" for c in (
        "dbscan", "union", "merge", "nwck2phy", "tsv2phy", "tsv2nwck",
        "rarify", "trim", "phycmp", "fullphy", "makespan", "seq2fasta")]


def _body(path):
    """The module's syntax tree without its docstring, and the docstring."""
    tree = ast.parse(path.read_text())
    doc = ast.get_docstring(tree, clean=False)
    del tree.body[0]
    return ast.dump(tree), doc


@pytest.mark.parametrize("rel", _COPIES)
def test_copy_differs_only_in_docstring(rel):
    ours, odoc = _body(REPO / "ccphylo_tpu_torch" / rel)
    ref, rdoc = _body(REPO / "ccphylo_tpu" / rel)
    assert ours == ref
    assert odoc.startswith(rdoc) and f"ccphylo_tpu/{rel}" in odoc


# ---------------------------------------------------------------------
# io/tsv.py, ops/distcmp.py


def _tsv_bytes(seed):
    rng = np.random.default_rng(seed)
    rows = [b"\t".join(b"c%d" % i for i in range(7)), b"#x\ty\tz\tu\tv\tw\tq"]
    for _ in range(12):
        rows.append(b"\t".join(b"%.3f" % v for v in rng.random(7) * 40))
    return b"\n".join(rows) + b"\n"


@pytest.mark.parametrize("dtype", ["d", "f", "s", "b"])
def test_load_tsv(dtype):
    data = _tsv_bytes(1)
    outs = []
    for m in (p_tsv, r_tsv):
        got = []
        for bs in (1.0, 4.0):
            dat = m.load_tsv(data, dtype=dtype, bytescale=bs)
            got += [dat.mat, dat.logical(), dat.m, dat.n]
        got.append(m.load_tsv(b"a\tb\n"))
        with pytest.raises(SystemExit) as exc:
            m.load_tsv(b"a\tb\n1\t2\n3\n")
        got.append(str(exc.value))
        outs.append(got)
    _same(*outs)


_DISTCMP = sorted(r_dcmp.METRICS) + ["l3", "l0.5", "l1.5", "lx", "q"]


@pytest.mark.parametrize("metric", _DISTCMP)
def test_distcmp(metric):
    data = _tsv_bytes(_DISTCMP.index(metric) + 2)
    outs = []
    for m, t in ((p_dcmp, p_tsv), (r_dcmp, r_tsv)):
        fn = m.get_distcmp(metric)
        got = [fn is None]
        for dtype in ("d", "f", "s", "b") if fn is not None else ():
            dat = t.load_tsv(data, dtype=dtype, bytescale=8.0)
            got += [fn(dat.mat[i], dat.mat[j], dtype, 8.0)
                    for i in range(dat.m) for j in range(i)]
        outs.append(got)
    assert outs[0][0] == (metric in ("lx", "q"))
    _same(*outs)


# ---------------------------------------------------------------------
# io/newick_parse.py

_NWCK = (b"(A:0.1,(B:0.2,C:0.3):0.05,D:0.4);\n>t2(X:1,Y:2);\n"
         b"((aa:1.500,bb:2.500):0.500,(cc:3.000,(dd:1.000,ee:0.250):0.125)"
         b":2.000,ff:7.000);\n"
         b"h3(((pp:1.0,qq:2.0):3.0,rr:4.0):-1.0,(ss:5.0,tt:6.0):7.0);\n")


def _split_all(m, node):
    """Split the tree into its n nodes in nwck2phy's order
    (cli/nwck2phy_cmd.py:newick_to_matrix)."""
    n = m.get_size_nwck(node)
    names, out, org = [node], [], 0
    while len(names) != n:
        got = m.split_nwck(names[org])
        if got is None:
            org += 1
            continue
        names.append(got[0])
        out.append((org, got[1], got[2]))
    return out + [(nd.s, nd.len) for nd in names]


def test_newick_parse():
    outs = []
    for m in (p_nwp, r_nwp):
        got = []
        for header, node in m.iter_nwck(_NWCK):
            got += [header, node.s, node.len, m.get_size_nwck(node),
                    _split_all(m, node)]
        outs.append(got)
    assert len(outs[0]) == 4 * 5
    _same(*outs)


# ---------------------------------------------------------------------
# io/hashmapstr.py


def test_hashmapstr():
    rng = np.random.default_rng(5)
    keys = [b"tpl%d" % k for k in rng.integers(0, 400, 1500)]
    gone = [b"tpl%d" % k for k in rng.integers(0, 450, 100)]
    outs = []
    for m in (p_hmap, r_hmap):
        h = m.HashMapStr()
        got = [h.add(k, i) for i, k in enumerate(keys)]
        got += [h.mask, h.n, list(h.items_in_print_order())]
        got += [h.pop(k) for k in gone]
        got += [h.n, list(h.items_in_print_order()),
                m.djb2(b"tplD gene1"), m.minimal_standard(12345)]
        outs.append(got)
    assert outs[0][1500] > 127  # the table grew
    _same(*outs)


# ---------------------------------------------------------------------
# io/kmadb.py


def test_kmadb(tmp_path):
    rng = np.random.RandomState(9)
    names = [b"t%d" % i for i in range(6)]
    seqs = [bytes(rng.choice(list(b"ACGT"), int(n)).tolist())
            for n in rng.randint(1, 150, len(names))]
    _write_kma_db(tmp_path, "db", seqs, names)
    db = str(tmp_path / "db")
    words = rng.randint(0, 2 ** 63, 8, dtype=np.int64).astype(np.uint64)
    outs = []
    for m in (p_kmadb, r_kmadb):
        got = [m.unpack_seq(words, n) for n in (0, 1, 31, 32, 33, 256)]
        got += [m.get_lengths(db), m.read_names(db)]
        got += [list(m.iter_fastas(db, sl))
                for sl in (None, [2, 4], [1], [0, 6, 9])]
        outs.append(got)
    assert [s for _, s in outs[0][8]] == seqs
    _same(*outs)


# ---------------------------------------------------------------------
# schedule/makespan.py


def _jobs_tsv():
    rng = np.random.RandomState(11)
    rows = [b"#id\tsize\tcluster\tw\tcls"]
    for i in range(60):
        rows.append(b"%d\t%d\t%d\t%.2f\t%d"
                    % (i, rng.randint(1, 50), rng.randint(0, 12),
                       rng.uniform(0.5, 9.0), rng.randint(0, 3)))
    return b"\n".join(rows) + b"\n"


def _schedule(mk, cmd, method, tabu, mv_cols, loads, capsys):
    data = _jobs_tsv()
    if mv_cols:
        jobs, n, mv = cmd.load_mv_jobs(data, b"\t", 3, mv_cols)
    else:
        (jobs, n), mv = cmd.load_jobs(data, b"\t", 3), 0
    mk.apply_weight(jobs, n, "log", 2.0, mv)
    m = len(loads) if loads else 3
    machines = mk.init_machines(m, n, mv, jobs, loads)
    M = mk.run_method(method, machines, jobs, m, n, mk.Methods(mv > 1))
    got = [mk.trade(M, tabu, mv > 1) if tabu else None]
    mk.print_stats(M)
    out, mout = io.BytesIO(), io.BytesIO()
    mk.print_makespan(M, out, mout)
    return got + [out.getvalue(), mout.getvalue(), capsys.readouterr()]


@pytest.mark.parametrize("mv_cols", [None, [4, 5]])
@pytest.mark.parametrize("tabu", [None, "BB", "DBEB"])
@pytest.mark.parametrize("method", ["DBF", "DFF", "DBE", "DFE"])
def test_makespan_run_method(method, tabu, mv_cols, capsys):
    loads = None if mv_cols else [2.0, 1.0, 1.5]
    outs = [_schedule(mk, cmd, method, tabu, mv_cols, loads, capsys)
            for mk, cmd in ((p_mk, p_mkcmd), (r_mk, r_mkcmd))]
    assert outs[0][1].count(b"\n") == 1 + len(set(
        ln.split(b"\t")[2] for ln in _jobs_tsv().split(b"\n")[1:-1]))
    _same(*outs)
