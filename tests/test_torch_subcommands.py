"""The port's twelve host subcommands (dbscan, union, merge, nwck2phy,
tsv2phy, tsv2nwck, rarify, trim, phycmp, fullphy, makespan, seq2fasta)
against the JAX package's, on the CPU: `python -m ccphylo_tpu_torch` and
`python -m ccphylo_tpu` run side by side on copies of the same
numpy-seeded inputs, each in its own directory, and must agree in exit
code, stdout bytes, the bytes of every file left in the directory, and
stderr bytes.  The only stderr lines masked are fullphy's two
`# Total time` lines (process CPU time).  Tracebacks of the error paths
name each package's own files, so there the package name and the line
numbers are masked and every other byte compared.

The option sets are those of the oracle tests, which need the reference
binary: tests/test_subcommands_parity.py:73-160,
tests/test_sched_misc_parity.py:110-200, tests/test_trim_parity.py:57-92
and tests/test_meth_parity.py:100-120.  Tolerance 0."""

import gzip
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from .conftest import REPO
from .gen_kma_data import make_dataset
from .test_meth_parity import MOTIFS, TRIM_ARGS
from .test_sched_misc_parity import MK_COMBOS, _write_kma_db
from .test_trim_parity import DETERMINISTIC, FILES, GARBAGE

PKGS = ("ccphylo_tpu", "ccphylo_tpu_torch")
_ENV = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
        "JAX_PLATFORMS": "cpu", "CCPHYLO_TPU_ENGINE": "exact",
        "CCPHYLO_TORCH_DEVICE": "cpu"}

_RES_HEADER = (b"#Template\tScore\tExpected\tTemplate_length\t"
               b"Template_Identity\tTemplate_Coverage\tQuery_Identity\t"
               b"Query_Coverage\tDepth\tq_value\tp_value\n")


def _res_files(d, prefix, seed, tpls, p):
    """KMA .res files (test_subcommands_parity.py:44-65,
    test_sched_misc_parity.py:70-90)."""
    rng = np.random.RandomState(seed)
    for s in range(4):
        rows = [_RES_HEADER]
        for t in tpls:
            if rng.rand() < p:
                cov = rng.uniform(20, 100)
                rows.append(b"%s\t%d\t%d\t%d\t%.2f\t%.2f\t%.2f\t%.2f\t"
                            b"%.2f\t%.1f\t1.0e-10\n"
                            % (t, rng.randint(100, 10**5),
                               rng.randint(1, 100),
                               rng.randint(500, 5000),
                               rng.uniform(80, 100), cov,
                               rng.uniform(80, 100), cov,
                               rng.uniform(0.5, 60),
                               rng.uniform(10, 1000)))
        (d / f"{prefix}{s}.res").write_bytes(b"".join(rows))
    return rng


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """Every input of every case, in one directory."""
    d = tmp_path_factory.mktemp("subcmd_in")
    make_dataset(d, n_samples=10, length=400)
    fsas = sorted(p.name for p in d.glob("*.fsa.gz"))
    # the Phylip matrix as tests/test_torch_cli.py:282-286 makes it
    res = subprocess.run([sys.executable, "-m", "ccphylo_tpu", "dist",
                          "-r", "tpl1", "-f", "17", "-i"] + fsas,
                         capture_output=True, cwd=d, timeout=600, env=_ENV)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    (d / "test.phy").write_bytes(res.stdout)
    # perturbed copy for phycmp (test_subcommands_parity.py:34-43)
    rng = np.random.RandomState(0)
    lines = (d / "test.phy").read_bytes().decode().strip().split("\n")
    out = [lines[0]]
    for ln in lines[1:]:
        parts = ln.split("\t")
        vals = [f"{float(v) * rng.uniform(0.9, 1.1):.6f}"
                for v in parts[1:]]
        out.append("\t".join([parts[0]] + vals))
    (d / "pert.phy").write_text("\n".join(out) + "\n")
    # Newick stream for nwck2phy (test_subcommands_parity.py:101-105)
    res = subprocess.run([sys.executable, "-m", "ccphylo_tpu", "tree",
                          "-i", "test.phy"], capture_output=True, cwd=d,
                         timeout=600, env=_ENV)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    (d / "t.nwck").write_bytes(
        res.stdout + b"(A:0.1,(B:0.2,C:0.3):0.05,D:0.4);\n>t2(X:1,Y:2);\n")
    _res_files(d, "r", 5, [b"tplA", b"tplB", b"tplC", b"tplD gene1",
                           b"tplE"], 0.75)
    # tsv rows (test_subcommands_parity.py:66-71)
    rng = np.random.RandomState(2)
    rows = ["\t".join(f"c{i}" for i in range(6))]
    for _ in range(10):
        rows.append("\t".join(f"{v:.3f}" for v in rng.rand(6) * 50))
    (d / "t.tsv").write_text("\n".join(rows) + "\n")
    (d / "nn.tsv").write_bytes(b"a\tb\tc\n1.0\t2.0\t3.0\n1.1\t2.1\t3.1\n"
                               b"9.0\t1.0\t0.5\n1.05\t2.05\t3.05\n")
    # multi-matrix streams for merge (test_subcommands_parity.py:115-125)
    (d / "m.phy").write_bytes(b"         3\na\nb\t1.5\nc\t2.25\t0.75\n"
                              b"         3\nb\nc\t2.5\nd\t1.25\t3.5\n")
    (d / "m.num").write_bytes(b"         3\na\nb\t100\nc\t200\t300\n"
                              b"         3\nb\nc\t50\nd\t150\t250\n")
    # KMA count matrix for rarify (test_subcommands_parity.py:137-143)
    (d / "s.mat").write_bytes(b"#tpl1\n"
                              b"A\t30\t1\t0\t2\t0\t0\n"
                              b"C\t0\t25\t0\t0\t1\t0\n"
                              b"-\t0\t0\t0\t0\t0\t12\n"
                              b"T\t0\t0\t1\t40\t0\t0\n\n")
    # jobs, .res files and a KMA index (test_sched_misc_parity.py:58-98)
    rng = np.random.RandomState(11)
    rows = [b"#id\tsize\tcluster\tw\tcls"]
    for i in range(60):
        rows.append(b"%d\t%d\t%d\t%.2f\t%d"
                    % (i, rng.randint(1, 50), rng.randint(0, 12),
                       rng.uniform(0.5, 9.0), rng.randint(0, 3)))
    (d / "jobs.tsv").write_bytes(b"\n".join(rows) + b"\n")
    tpls = [b"tplA", b"tplB", b"tplC", b"tplD", b"tplE"]
    rng = _res_files(d, "b", 7, tpls, 0.7)
    seqs = [bytes(rng.choice(list(b"ACGT"), int(rng.randint(40, 120)))
                  .tolist()) for _ in tpls]
    _write_kma_db(d, "db", seqs, tpls)
    # one multi-record fasta for trim's msa mode (test_trim_parity.py:74-84)
    msa = []
    for s in range(4):
        data = gzip.decompress((d / f"s{s:02d}.fsa.gz").read_bytes())
        for chunk in data.split(b">")[1:]:
            lines = chunk.split(b"\n")
            if lines[0].strip() == b"tpl1":
                msa.append(b">sample%02d\n" % s + b"\n".join(lines[1:]))
    (d / "msa.fsa").write_bytes(b"".join(msa))
    # longer templates so every motif occurs (test_meth_parity.py:36-44)
    (d / "meth").mkdir()
    make_dataset(d / "meth", n_samples=6, length=1600, seed=11)
    (d / "meth" / "motifs.fa").write_bytes(MOTIFS)
    return d


def _files(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


_TIMES = re.compile(rb"^(# Total time (?:used loading matrix|outputting "
                    rb"full matrix): )[0-9.]+( s\.)$", re.M)


def _both(base, tmp_path, args, cwd="."):
    """Run both packages on their own copies of the inputs, side by side;
    return ((rc, stdout, stderr, files) of the JAX package, of the port)."""
    procs = []
    for pkg in PKGS:
        d = tmp_path / pkg
        shutil.copytree(base, d)
        procs.append((d, subprocess.Popen(
            [sys.executable, "-m", pkg] + args, cwd=d / cwd, env=_ENV,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    out = []
    for d, p in procs:
        so, se = p.communicate(timeout=300)
        if args[0] == "fullphy":
            se = _TIMES.sub(rb"\1T\2", se)
        out.append((p.returncode, so, se, _files(d)))
    return out


def _same(base, tmp_path, args, cwd=".", rc=0):
    ref, ours = _both(base, tmp_path, args, cwd)
    assert ref[0] == rc, ref[2].decode(errors="replace")
    assert ours[:3] == ref[:3]
    assert ours[3].keys() == ref[3].keys()
    for name in ref[3]:
        assert ours[3][name] == ref[3][name], name
    return ref


# tests/test_subcommands_parity.py:73-160

@pytest.mark.parametrize("extra", [[], ["-f", "0"], ["-x", "3"],
                                   ["-s", "1e2"], ["-p"]])
def test_fullphy(base, tmp_path, extra):
    ref = _same(base, tmp_path, ["fullphy", "-i", "test.phy"] + extra)
    assert ref[1]
    assert ref[2].count(b"# Total time ") == ref[2].count(b": T s.") == 2


@pytest.mark.parametrize("extra", [["-f", "127"], ["-f", "127", "-s", "1e2"],
                                   ["-f", "127", "-b", "8"],
                                   ["-f", "127", "-p"]])
def test_phycmp(base, tmp_path, extra):
    ref = _same(base, tmp_path, ["phycmp", "-i", "test.phy", "pert.phy"]
                + extra)
    assert ref[1]


@pytest.mark.parametrize("extra", [[], ["-e", "0.05"],
                                   ["-e", "0.02", "-N", "3"],
                                   ["-s", "1e2"]])
def test_dbscan(base, tmp_path, extra):
    assert _same(base, tmp_path, ["dbscan", "-i", "test.phy"] + extra)[1]


@pytest.mark.parametrize("extra", [[], ["-E", "15"], ["-C", "30"],
                                   ["-L", "2000"]])
def test_union(base, tmp_path, extra):
    assert _same(base, tmp_path, ["union", "-i", "r0.res", "r1.res",
                                  "r2.res", "r3.res"] + extra)[1]


@pytest.mark.parametrize("extra", [[], ["-f", "5"], ["-x", "3"],
                                   ["-s", "1e2"], ["-b", "16"], ["-p"]])
def test_nwck2phy(base, tmp_path, extra):
    assert _same(base, tmp_path, ["nwck2phy", "-i", "t.nwck"] + extra)[1]


@pytest.mark.parametrize("args", [
    ["-i", "m.phy", "-w", "m.num", "-o", "out.phy", "-n", "out.num"],
    ["-i", "m.phy"]])
def test_merge(base, tmp_path, args):
    ref = _same(base, tmp_path, ["merge"] + args)
    assert ref[1] or ref[3]["out.phy"] and ref[3]["out.num"]


@pytest.mark.parametrize("extra", [["-A", "1000", "-R", "100"],
                                   ["-A", "7", "-R", "3"]])
def test_rarify(base, tmp_path, extra):
    assert _same(base, tmp_path, ["rarify", "-i", "s.mat"] + extra)[1]


@pytest.mark.parametrize("extra", [[], ["-d", "bc"], ["-d", "l1"],
                                   ["-d", "l2"], ["-d", "linf"],
                                   ["-d", "p"], ["-d", "chi2"],
                                   ["-d", "l3"], ["-p"], ["-s", "1e2"],
                                   ["-b", "16"], ["-p", "-d", "l2"]])
def test_tsv2phy(base, tmp_path, extra):
    assert _same(base, tmp_path, ["tsv2phy", "-i", "t.tsv"] + extra)[1]


# tests/test_sched_misc_parity.py:110-200

@pytest.mark.parametrize("extra", MK_COMBOS)
def test_makespan(base, tmp_path, extra):
    ref = _same(base, tmp_path, ["makespan", "-i", "jobs.tsv"] + extra)
    assert ref[1] and ref[2]  # partitioning + trades/stats report


def test_makespan_split_outputs(base, tmp_path):
    ref = _same(base, tmp_path, ["makespan", "-i", "jobs.tsv", "-o",
                                 "oj.tsv", "-O", "om.tsv"])
    assert ref[3]["oj.tsv"] and ref[3]["om.tsv"]


@pytest.mark.parametrize("extra", [[], ["-seqs", "2,4"], ["-seqs", "1"]])
def test_seq2fasta(base, tmp_path, extra):
    assert _same(base, tmp_path, ["seq2fasta", "-t_db", "db"] + extra)[1]


_BRES = ["b0.res", "b1.res", "b2.res", "b3.res"]


@pytest.mark.parametrize("extra", [[], ["-E", "15"]])
def test_union_db_order(base, tmp_path, extra):
    """union -B without -o writes a literal file named "-"."""
    ref = _same(base, tmp_path, ["union", "-i"] + _BRES + ["-B", "db"]
                + extra)
    assert ref[1] == b"" and ref[3]["-"]


@pytest.mark.parametrize("extra", [[], ["-E", "15"]])
def test_union_db_order_o(base, tmp_path, extra):
    ref = _same(base, tmp_path, ["union", "-i"] + _BRES
                + ["-B", "db", "-o", "ob.tsv"] + extra)
    assert ref[3]["ob.tsv"]


def test_union_ref_fasta(base, tmp_path):
    ref = _same(base, tmp_path, ["union", "-i"] + _BRES
                + ["-B", "db", "-r", "ref.fsa", "-o", "ou.tsv"])
    assert ref[3]["ou.tsv"] and ref[3]["ref.fsa"]


@pytest.mark.parametrize("tsv", ["nn.tsv", "t.tsv"])
def test_tsv2nwck(base, tmp_path, tsv):
    assert _same(base, tmp_path, ["tsv2nwck", "-i", tsv])[1] \
        .endswith(b";\n")


# tests/test_trim_parity.py:57-92 and tests/test_meth_parity.py:100-120

@pytest.mark.parametrize("extra", DETERMINISTIC + GARBAGE)
def test_trim(base, tmp_path, extra):
    assert _same(base, tmp_path, ["trim", "-i"] + FILES + extra)[1]


@pytest.mark.parametrize("extra", [["-f", "1"], ["-f", "16"], ["-f", "17"],
                                   [], ["-P", "5"]])
def test_trim_msa_mode(base, tmp_path, extra):
    assert _same(base, tmp_path, ["trim", "-i", "msa.fsa"] + extra)[1]


@pytest.mark.parametrize("extra", TRIM_ARGS)
def test_trim_meth(base, tmp_path, extra):
    files = sorted(p.name for p in (base / "meth").glob("*.fsa.gz"))
    assert _same(base, tmp_path, ["trim", "-i"] + files
                 + ["-r", "tpl1", "-y", "motifs.fa"] + extra, cwd="meth")[1]


# error paths

_MISSING = {
    "dbscan": ["-i", "nosuch.phy"],
    "union": ["-i", "nosuch.res"],
    "merge": ["-i", "nosuch.phy"],
    "nwck2phy": ["-i", "nosuch.nwck"],
    "tsv2phy": ["-i", "nosuch.tsv"],
    "tsv2nwck": ["-i", "nosuch.tsv"],
    "rarify": ["-i", "nosuch.mat", "-A", "10"],
    "trim": ["-i", "nosuch.fsa"],
    "phycmp": ["-i", "test.phy", "nosuch.phy"],
    "fullphy": ["-i", "nosuch.phy"],
    "makespan": ["-i", "nosuch.tsv"],
    "seq2fasta": ["-t_db", "nosuch"],
}


def _tb(err):
    """A traceback with the package's name and line numbers masked."""
    return re.sub(rb", line \d+,", b", line N,",
                  err.replace(b"ccphylo_tpu_torch", b"ccphylo_tpu"))


@pytest.mark.parametrize("cmd", sorted(_MISSING))
def test_missing_input_file(base, tmp_path, cmd):
    ref, ours = _both(base, tmp_path, [cmd] + _MISSING[cmd])
    assert ref[0] != 0 and ours[:2] == ref[:2] and ours[3] == ref[3]
    assert b"No such file or directory" in ref[2]
    assert _tb(ours[2]) == _tb(ref[2])


@pytest.mark.parametrize("cmd", sorted(_MISSING))
def test_unknown_option(base, tmp_path, cmd):
    ref = _same(base, tmp_path, [cmd, "-Z"], rc=1)
    assert ref[2] and ref[1] == b""


@pytest.mark.parametrize("cmd", sorted(_MISSING))
def test_long_help(base, tmp_path, cmd):
    ref = _same(base, tmp_path, [cmd, "--help"],
                rc=1 if cmd == "seq2fasta" else 0)
    assert ref[1] or ref[2]
