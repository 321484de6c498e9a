"""The port's CLI (python -m ccphylo_tpu_torch) against the JAX package's
(python -m ccphylo_tpu), byte for byte, on the CPU, on every route:
`dist` on the torch path (the default; here CCPHYLO_TORCH_DEVICE=cpu,
so the plain versions) and on the host numpy kernels
(CCPHYLO_TORCH_DIST=host); `tree` on every route of
CCPHYLO_TORCH_ENGINE: unset (-m dnj -b on the packed engine, integer
matrices of every method and -m dnj -s on the float64 device engines,
the rest on the host), device, device64, packed (and its alias
packed64), sharded (a gloo group of one rank) and exact.
Also: the port imports no jax and nothing of the JAX package, runs on
the card unless asked for the CPU (and raises without a card), prints
the reference's version and help, gives each of the other twelve
subcommands' help as the reference does (tests/test_torch_subcommands.py
holds them to the reference on every option set), and writes a
torch.profiler Chrome trace under CCPHYLO_TORCH_PROFILE=<dir>."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from .conftest import REPO
from .gen_kma_data import make_dataset

# Small shapes: one intra-op thread.  The JAX CPU backend's worker
# threads share the cores in this process, and torch's OpenMP pool
# then stalls on every small op of the engine loop.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def kma_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kma_torch")
    make_dataset(d, n_samples=6, length=400)
    return d


def _run(pkg, args, cwd, extra_env=None, check=True):
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "CCPHYLO_TORCH_DEVICE": "cpu"}
    env.update(extra_env or {})
    env = {k: v for k, v in env.items() if v is not None}
    res = subprocess.run([sys.executable, "-m", pkg] + args,
                         capture_output=True, cwd=cwd, timeout=600, env=env)
    if check:
        assert res.returncode == 0, res.stderr.decode(errors="replace")
    return res


def _fsas(d):
    return sorted(os.path.basename(p) for p in glob.glob(str(d / "*.fsa.gz")))


# tmpl_1 names no template of make_dataset (all samples are trimmed
# away, as in tests/test_device_paths.py); tpl1 drives the kernels
@pytest.mark.parametrize("template", ["tmpl_1", "tpl1"])
@pytest.mark.parametrize("flags", [["-f", "17"], ["-f", "19"]])
def test_dist_matches_jax_device_path(kma_dir, template, flags):
    """No CCPHYLO_TORCH_DIST: the torch path is the default (here on
    CCPHYLO_TORCH_DEVICE=cpu, the plain versions)."""
    args = ["dist", "-r", template] + flags + ["-i"] + _fsas(kma_dir)
    jax_out = _run("ccphylo_tpu", args, kma_dir,
                   {"CCPHYLO_TPU_DIST": "device"}).stdout
    ours = _run("ccphylo_tpu_torch", args, kma_dir).stdout
    assert ours == jax_out
    if template == "tpl1":
        assert ours.count(b"\n") == 7  # size line + 6 rows


@pytest.mark.parametrize("flags", [["-f", "17"], ["-f", "19"],
                                   ["-f", "17", "-P", "3"]])
def test_dist_host_route_matches_reference(kma_dir, flags):
    """CCPHYLO_TORCH_DIST=host: the port's numpy kernels, with no
    CCPHYLO_TORCH_DEVICE at all (nothing touches a torch device); and
    the old spelling `device` is the default path."""
    args = ["dist", "-r", "tpl1"] + flags + ["-i"] + _fsas(kma_dir)
    ref = _run("ccphylo_tpu", args, kma_dir)
    ours = _run("ccphylo_tpu_torch", args, kma_dir,
                {"CCPHYLO_TORCH_DIST": "host", "CCPHYLO_TORCH_DEVICE": ""})
    assert ours.stdout == ref.stdout and ours.stderr == ref.stderr
    assert ours.stdout.count(b"\n") == 7
    same = _run("ccphylo_tpu_torch", args, kma_dir,
                {"CCPHYLO_TORCH_DIST": "device"})
    assert same.stdout == ref.stdout


def _mats(d):
    return sorted(os.path.basename(p) for p in glob.glob(str(d / "*.mat.gz")))


def _cells(out):
    """The cells of a Phylip matrix as floats, and its size line."""
    lines = out.split(b"\n")
    return [float(x) for ln in lines[1:] if ln
            for x in ln.split(b"\t")[1:]], lines[0]


def _notes(stderr):
    return [ln for ln in stderr.splitlines()
            if ln.startswith(b"# ccphylo_tpu_torch")]


@pytest.mark.parametrize("extra", [["-d", "l1"], ["-d", "linf"], ["-d", "z"],
                                   ["-d", "l1", "-W", "1000"]])
def test_dist_mat_input_runs_host_metrics(kma_dir, tmp_path, extra):
    """.mat input, -d l1 / linf / z, no CCPHYLO_TORCH_DIST: the metric table
    of ops/matdist_torch.py on the torch device (here the CPU) writes the
    bytes of the host metrics and of the reference, stderr and the number
    matrix included."""
    args = ["dist", "-r", "tpl1", "-i"] + _mats(kma_dir) + extra
    outs = []
    for pkg, env in (("ccphylo_tpu", {}),
                     ("ccphylo_tpu_torch", {"CCPHYLO_TORCH_DIST": "host",
                                            "CCPHYLO_TORCH_DEVICE": "cuda"}),
                     ("ccphylo_tpu_torch", {})):
        num = tmp_path / f"n{len(outs)}.num"
        res = _run(pkg, args + ["-n", str(num)], kma_dir, env)
        outs.append((res.stdout, res.stderr, num.read_bytes()))
    assert outs[0] == outs[1] == outs[2]
    assert outs[2][0].count(b"\n") == 7 and not _notes(outs[2][1])


@pytest.mark.parametrize("method", ["cos", "bc", "chi2"])
def test_dist_mat_float_metric_default_is_the_host(kma_dir, method):
    """A metric whose float sums depend on their order stays on the host
    metrics when no variable is set: the reference's bytes, no torch
    device needed, and one stderr line that names the variable which
    forces the card."""
    args = ["dist", "-r", "tpl1", "-d", method, "-i"] + _mats(kma_dir)
    ref = _run("ccphylo_tpu", args, kma_dir)
    ours = _run("ccphylo_tpu_torch", args, kma_dir,
                {"CCPHYLO_TORCH_DEVICE": "cuda"})  # never reached
    assert ours.stdout == ref.stdout and ours.stdout.count(b"\n") == 7
    notes = _notes(ours.stderr)
    assert len(notes) == 1 and b"CCPHYLO_TORCH_DIST=device" in notes[0]
    assert b"-d " + method.encode() in notes[0]
    rest = [ln for ln in ours.stderr.splitlines() if ln not in notes]
    assert rest == ref.stderr.splitlines()
    quiet = _run("ccphylo_tpu_torch", args, kma_dir,
                 {"CCPHYLO_TORCH_DIST": "host", "CCPHYLO_TORCH_DEVICE": ""})
    assert quiet.stdout == ref.stdout and quiet.stderr == ref.stderr


@pytest.mark.parametrize("method", ["cos", "chi2", "nc", "z", "l3", "l1"])
def test_dist_mat_device_route_matches_jax_device(kma_dir, tmp_path, method):
    """CCPHYLO_TORCH_DIST=device: every metric the table knows runs on
    the torch device in float64.  Cells within the float32 tolerance of
    the reference under CCPHYLO_TPU_DIST=device (2e-5, its own test's)
    and within 1e-9 of the host metrics (float64 sums in another order,
    printed with 9 digits); the number matrix (rows_inc) is exact."""
    args = ["dist", "-r", "tpl1", "-d", method, "-i"] + _mats(kma_dir)
    nums = [tmp_path / f"{k}.num" for k in "jho"]
    jax_out = _run("ccphylo_tpu", args + ["-n", str(nums[0])], kma_dir,
                   {"CCPHYLO_TPU_DIST": "device"}).stdout
    host = _run("ccphylo_tpu_torch", args + ["-n", str(nums[1])], kma_dir,
                {"CCPHYLO_TORCH_DIST": "host"}).stdout
    res = _run("ccphylo_tpu_torch", args + ["-n", str(nums[2])], kma_dir,
               {"CCPHYLO_TORCH_DIST": "device"})
    assert not _notes(res.stderr)
    (j, jsize), (h, hsize), (o, osize) = (_cells(x) for x in
                                          (jax_out, host, res.stdout))
    assert jsize == hsize == osize and len(o) == len(j) == len(h) == 15
    for a, b, c in zip(o, j, h):
        assert abs(a - b) <= 2e-5 * max(abs(b), 1.0), (a, b)
        assert abs(a - c) <= 1e-9 * max(abs(c), 1.0), (a, c)
    assert nums[2].read_bytes() == nums[1].read_bytes() \
        == nums[0].read_bytes()


def test_dist_mat_union_on_the_torch_path(kma_dir):
    """Union-stream mode: -d l1 by default and -d z under
    CCPHYLO_TORCH_DIST=device (its values are all 0, so its bytes are the
    host's too) go through the metric table; -d cos by default is the
    host with one note for the whole run."""
    u = b"6\ts00\ts01\ts02\ts03\ts04\ts05\n"
    u += b"tpl1\t6\t0\t1\t2\t3\t4\t5\n"
    u += b"tpl2\t4\t0\t2\t3\t5\n"
    (kma_dir / "t.union").write_bytes(u)
    for method, mode in (("l1", None), ("z", "device")):
        args = ["dist", "-i", "t.union", "-d", method]
        ref = _run("ccphylo_tpu", args, kma_dir)
        ours = _run("ccphylo_tpu_torch", args, kma_dir,
                    {"CCPHYLO_TORCH_DIST": mode})
        assert ours.stdout == ref.stdout and ours.stderr == ref.stderr
        assert ours.stdout.count(b"\n") == 7 + 5
    args = ["dist", "-i", "t.union", "-d", "cos"]
    ours = _run("ccphylo_tpu_torch", args, kma_dir)
    assert ours.stdout == _run("ccphylo_tpu", args, kma_dir).stdout
    assert len(_notes(ours.stderr)) == 1


def _write_mat(path, deep, template="tpl1", length=200, inserts=0):
    """A .mat file of `length` reference rows, 30 reads where `deep`
    holds and 2 elsewhere, behind `inserts` deep insertion rows."""
    rows = [b"#" + template.encode()]
    rows += [b"-\t0\t0\t0\t0\t0\t30"] * inserts
    for p in range(length):
        d = 30 if deep(p) else 2
        rows.append(b"ACGT"[p % 4:p % 4 + 1] + b"\t%d\t%d\t0\t0\t0\t0"
                    % ((d, 0) if p % 3 else (d - 1, 1)))
    path.write_bytes(b"\n".join(rows) + b"\n\n")


@pytest.mark.parametrize("case", ["messages", "exit"])
def test_dist_mat_card_route_keeps_the_order_of_stderr(tmp_path, case):
    """Files that are left out while loading (template missing, too few
    deep rows) between pairs without enough overlap: the default -d l1
    route, which scores its pairs after all files are loaded, writes the
    host route's stderr line for line, and its exit at a sample whose
    stripped rows fall short comes with the same lines before it."""
    def everywhere(p):
        return True
    _write_mat(tmp_path / "a.mat", everywhere)
    _write_mat(tmp_path / "b.mat", lambda p: p < 100)
    _write_mat(tmp_path / "c.mat", lambda p: p >= 100)
    _write_mat(tmp_path / "m.mat", everywhere, template="other")
    _write_mat(tmp_path / "f.mat", lambda p: p < 50)
    # passes as loaded (170 deep rows of 300), fails once the insertion
    # rows are stripped (70 of 200)
    _write_mat(tmp_path / "x.mat", lambda p: p < 70, inserts=100)
    files = {"messages": ["a", "b", "c", "m", "a", "f", "c"],
             "exit": ["a", "x", "b", "m", "c"]}[case]
    args = ["dist", "-r", "tpl1", "-d", "l1", "-C", "40", "-L", "50", "-i"] \
        + [f + ".mat" for f in files]
    outs = []
    for pkg, env in (("ccphylo_tpu", {}),
                     ("ccphylo_tpu_torch", {"CCPHYLO_TORCH_DIST": "host"}),
                     ("ccphylo_tpu_torch", {})):
        num = tmp_path / f"n{len(outs)}.num"
        res = _run(pkg, args + ["-n", str(num)], tmp_path, env, check=False)
        outs.append((res.returncode, res.stdout, res.stderr,
                     num.read_bytes() if num.exists() else None))
    assert outs[0] == outs[1] == outs[2]
    err = outs[2][2].decode()
    if case == "messages":
        assert outs[2][0] == 0 and outs[2][1].count(b"\n") == 6
        marks = [err.index("samples:\tc.mat\tb.mat"),
                 err.index("is not included in:\tm.mat"),
                 err.index("inclusion:\tf.mat"),
                 err.rindex("samples:\tc.mat\tb.mat")]
        assert marks == sorted(marks) and marks[0] < marks[3]
    else:
        assert outs[2][0] == 1 and outs[2][1] == b""
        assert err.rstrip().endswith("inclusion:\tx.mat")
        assert "m.mat" not in err


def test_dist_mat_card_route_without_card_raises(kma_dir):
    """-d l1 on .mat input is a card route: with no variable set and no
    card it raises, it never runs the host metrics quietly; so does any
    metric under CCPHYLO_TORCH_DIST=device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mats = _mats(kma_dir)
    for method, mode in (("l1", None), ("linf", None), ("z", None),
                         ("cos", "device")):
        res = _run("ccphylo_tpu_torch",
                   ["dist", "-r", "tpl1", "-d", method, "-i"] + mats, kma_dir,
                   {"CCPHYLO_TORCH_DEVICE": None, "CCPHYLO_TORCH_DIST": mode},
                   check=False)
        assert res.returncode != 0 and res.stdout == b"", method
        assert b"torch.cuda.is_available() is False" in res.stderr


def test_dist_tile_checkpoint_stays_on_the_host(kma_dir, tmp_path):
    """CCPHYLO_TORCH_DIST_CKPT fills the matrix tile by tile on the
    host, as CCPHYLO_TPU_CKPT does in the reference, and resumes."""
    args = ["dist", "-r", "tpl1", "-f", "17", "-i"] + _fsas(kma_dir)
    ref = _run("ccphylo_tpu", args, kma_dir,
               {"CCPHYLO_TPU_CKPT": str(tmp_path / "ref")}).stdout
    env = {"CCPHYLO_TORCH_DIST_CKPT": str(tmp_path / "ours"),
           "CCPHYLO_TORCH_DEVICE": "cuda"}  # never reached: no card needed
    for _ in range(2):
        assert _run("ccphylo_tpu_torch", args, kma_dir, env).stdout == ref
    assert (tmp_path / "ours" / "D.manifest.json").exists()


@pytest.fixture(scope="module")
def phy(kma_dir, tmp_path_factory):
    args = ["dist", "-r", "tpl1", "-f", "17", "-i"] + _fsas(kma_dir)
    f = tmp_path_factory.mktemp("phy_torch") / "d.phy"
    f.write_bytes(_run("ccphylo_tpu", args, kma_dir).stdout)
    return f


def test_tree_packed_matches_jax_packed(kma_dir, tmp_path):
    """No CCPHYLO_TORCH_ENGINE: -m dnj -b runs the packed engine."""
    args = ["dist", "-r", "tpl1", "-f", "17", "-i"] + _fsas(kma_dir)
    phy = tmp_path / "d.phy"
    phy.write_bytes(_run("ccphylo_tpu", args, kma_dir).stdout)
    targs = ["tree", "-m", "dnj", "-b", "-i", str(phy)]
    jax_out = _run("ccphylo_tpu", targs, tmp_path,
                   {"CCPHYLO_TPU_ENGINE": "packed"}).stdout
    ours = _run("ccphylo_tpu_torch", targs, tmp_path).stdout
    assert ours == jax_out and ours.endswith(b";\n")
    # the packed engine ran: without a device to run on it raises
    res = _run("ccphylo_tpu_torch", targs, tmp_path,
               {"CCPHYLO_TORCH_DEVICE": "cuda"}, check=False)
    assert res.returncode != 0 or torch.cuda.is_available()


@pytest.mark.parametrize("targs", [
    ["-m", "dnj", "-b"], ["-m", "dnj"], ["-m", "nj", "-p"],
    ["-m", "upgma", "-s", "4"], ["-m", "hnj", "-f", "3"], ["-m", "cf"]])
@pytest.mark.parametrize("engine", ["exact", None])
def test_tree_host_engine_matches_reference(phy, tmp_path, targs, engine):
    """CCPHYLO_TORCH_ENGINE=exact runs the port's host exact engine for
    every method and dtype and needs no torch device.  With no engine
    named, so do -p and the quantized dtypes of every method but dnj;
    the integer matrix of `dist` in double precision goes to the device
    engines (here on CCPHYLO_TORCH_DEVICE=cpu) and gives the same
    bytes."""
    args = ["tree"] + targs + ["-i", str(phy)]
    ref = _run("ccphylo_tpu", args, tmp_path).stdout
    env = {"CCPHYLO_TORCH_DEVICE": "cuda"}  # never reached on the host
    if engine:
        env["CCPHYLO_TORCH_ENGINE"] = engine
    elif targs[2:3] not in (["-p"], ["-s"]):
        env["CCPHYLO_TORCH_DEVICE"] = "cpu"  # a device engine's case
    ours = _run("ccphylo_tpu_torch", args, tmp_path, env).stdout
    assert ours == ref and ours.endswith(b";\n")


def test_tree_missing_cells_go_to_the_host_engine(tmp_path):
    """A matrix with missing cells cannot live in quantized storage:
    dnj -b and dnj -s run the host engine, as in the reference, also
    under device64."""
    f = tmp_path / "m.phy"
    f.write_bytes(b"         4\na\nb\t3\nc\t-1\t5\nd\t7\t4\t2\n")
    for dt, engine in (("-b", None), ("-s", None), ("-s", "device64")):
        args = ["tree", "-m", "dnj", dt, "-i", str(f)]
        ref = _run("ccphylo_tpu", args, tmp_path).stdout
        ours = _run("ccphylo_tpu_torch", args, tmp_path,
                    {"CCPHYLO_TORCH_DEVICE": "cuda",
                     "CCPHYLO_TORCH_ENGINE": engine}).stdout
        assert ours == ref and ours.endswith(b";\n")


@pytest.mark.parametrize("engine", ["packed32", "nonsense"])
def test_unported_engine_is_an_argument_error(phy, tmp_path, engine):
    """A value of CCPHYLO_TORCH_ENGINE that names no engine is an
    argument error (the reference runs its host engine quietly)."""
    res = _run("ccphylo_tpu_torch", ["tree", "-m", "dnj", "-i", str(phy)],
               tmp_path, {"CCPHYLO_TORCH_ENGINE": engine}, check=False)
    assert res.returncode == 1 and res.stdout == b""
    assert b"CCPHYLO_TORCH_ENGINE" in res.stderr
    assert b"sharded" in res.stderr  # the list of engines
    assert b"Traceback" not in res.stderr


@pytest.fixture(scope="module")
def int_phy(tmp_path_factory):
    """A seeded integer matrix of 30 taxa, complete."""
    import numpy as np
    n = 30
    rng = np.random.RandomState(14)
    rows = [b"%10d" % n]
    for i in range(n):
        cells = [b"%d" % v for v in rng.randint(1, 60, i)]
        rows.append(b"\t".join([b"t%02d" % i] + cells))
    f = tmp_path_factory.mktemp("iphy_torch") / "i.phy"
    f.write_bytes(b"\n".join(rows) + b"\n")
    return f


@pytest.mark.parametrize("method", ["dnj", "nj", "upgma"])
def test_tree_sharded_matches_reference(int_phy, tmp_path, method):
    """CCPHYLO_TORCH_ENGINE=sharded on CPU tensors (a gloo group of one
    rank): the bytes of CCPHYLO_TPU_ENGINE=sharded, float32 sums of small
    integers being exact; no note."""
    args = ["tree", "-m", method, "-i", str(int_phy)]
    ref = _run("ccphylo_tpu", args, tmp_path,
               {"CCPHYLO_TPU_ENGINE": "sharded"}).stdout
    res = _run("ccphylo_tpu_torch", args, tmp_path,
               {"CCPHYLO_TORCH_ENGINE": "sharded"})
    assert res.stdout == ref and ref.endswith(b";\n")
    assert b"# ccphylo_tpu_torch" not in res.stderr


@pytest.mark.parametrize("method,fixture", [("nj", "miss_phy"),
                                            ("upgma", "miss_phy"),
                                            ("hnj", "int_phy")])
def test_tree_sharded_host_stand_ins(request, tmp_path, method, fixture):
    """Under CCPHYLO_TORCH_ENGINE=sharded, nj / upgma with missing cells
    and the methods the sharded engines lack run the host engine, as the
    reference routes them, and say so in one stderr line."""
    args = ["tree", "-m", method, "-i", str(request.getfixturevalue(fixture))]
    ref = _run("ccphylo_tpu", args, tmp_path,
               {"CCPHYLO_TPU_ENGINE": "sharded"}).stdout
    assert ref == _run("ccphylo_tpu", args, tmp_path).stdout
    res = _run("ccphylo_tpu_torch", args, tmp_path,
               {"CCPHYLO_TORCH_ENGINE": "sharded",
                "CCPHYLO_TORCH_DEVICE": "cuda"})  # never reached
    assert res.stdout == ref and ref.endswith(b";\n")
    notes = [ln for ln in res.stderr.splitlines()
             if ln.startswith(b"# ccphylo_tpu_torch")]
    assert len(notes) == 1 and b"CCPHYLO_TORCH_ENGINE=sharded" in notes[0]


def test_tree_sharded_engine_that_ran(int_phy, miss_phy):
    """_dispatch_build.last_engine names the sharded engine that ran, in
    one process for all three (one process group)."""
    code = (
        "import sys\n"
        "from ccphylo_tpu_torch.cli import tree_cmd\n"
        "from ccphylo_tpu_torch.cli.main import main\n"
        "for f, m in [(sys.argv[1], 'dnj'), (sys.argv[1], 'nj'),\n"
        "             (sys.argv[1], 'upgma'), (sys.argv[2], 'dnj'),\n"
        "             (sys.argv[2], 'nj')]:\n"
        "    assert main(['tree', '-m', m, '-i', f, '-o', '/dev/null']) == 0\n"
        "    print(tree_cmd._dispatch_build.last_engine)\n")
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "CCPHYLO_TORCH_DEVICE": "cpu", "CCPHYLO_TORCH_ENGINE": "sharded"}
    res = subprocess.run([sys.executable, "-c", code, str(int_phy),
                          str(miss_phy)], capture_output=True, timeout=600,
                         env=env)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    assert res.stdout.split() == [b"sharded/dnj", b"sharded/nj",
                                  b"sharded/upgma", b"sharded/dnj", b"exact"]


@pytest.mark.parametrize("method", ["dnj", "upgma", "ff", "cf", "hnj", "nj",
                                    "mn"])
def test_tree_device_engines_match_reference(phy, tmp_path, method):
    """An integer matrix in double precision, every method: the port's
    default route and CCPHYLO_TORCH_ENGINE=device64 (the float64 device
    engines, here on CPU tensors) write the bytes of the reference under
    CCPHYLO_TPU_ENGINE=device64 and of its default host run; device
    (float32) is no argument error and writes a whole tree."""
    args = ["tree", "-m", method, "-i", str(phy)]
    host = _run("ccphylo_tpu", args, tmp_path).stdout
    jax64 = _run("ccphylo_tpu", args, tmp_path,
                 {"CCPHYLO_TPU_ENGINE": "device64"}).stdout
    assert jax64 == host and host.endswith(b";\n")
    for engine in (None, "device64"):
        res = _run("ccphylo_tpu_torch", args, tmp_path,
                   {"CCPHYLO_TORCH_ENGINE": engine})
        assert res.stdout == host, engine
        assert b"# ccphylo_tpu_torch" not in res.stderr
    f32 = _run("ccphylo_tpu_torch", args, tmp_path,
               {"CCPHYLO_TORCH_ENGINE": "device"}).stdout
    assert f32.count(b",") == host.count(b",") and f32.endswith(b";\n")


@pytest.mark.parametrize("targs,engine", [
    (["-s"], None), (["-s", "4"], None), (["-s", "4"], "device64"),
    (["-b"], "device64"), (["-s", "3"], "device64")])
def test_tree_quantized_device_engine_matches_reference(phy, tmp_path,
                                                        targs, engine):
    """-m dnj -s under a power-of-two ByteScale by default, and -s / -b
    under device64 at any ByteScale: u16 / u8 cells with float64
    compute write the host exact engine's bytes."""
    args = ["tree", "-m", "dnj"] + targs + ["-i", str(phy)]
    ref = _run("ccphylo_tpu", args, tmp_path).stdout
    ours = _run("ccphylo_tpu_torch", args, tmp_path,
                {"CCPHYLO_TORCH_ENGINE": engine}).stdout
    assert ours == ref and ours.endswith(b";\n")


def test_tree_card_route_without_card_raises(phy, tmp_path):
    """With no variable set an integer matrix needs the card for every
    method, as does a named device engine; -s under a ByteScale that is
    no power of two stays on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for targs, engine in ((["-m", "nj"], None), (["-m", "dnj", "-s"], None),
                          (["-m", "upgma"], "device"),
                          (["-m", "dnj"], "sharded")):
        res = _run("ccphylo_tpu_torch", ["tree"] + targs + ["-i", str(phy)],
                   tmp_path, {"CCPHYLO_TORCH_DEVICE": None,
                              "CCPHYLO_TORCH_ENGINE": engine}, check=False)
        assert res.returncode != 0 and res.stdout == b"", targs
        assert b"torch.cuda.is_available() is False" in res.stderr
    args = ["tree", "-m", "dnj", "-s", "3", "-i", str(phy)]
    assert _run("ccphylo_tpu_torch", args, tmp_path,
                {"CCPHYLO_TORCH_DEVICE": None}).stdout \
        == _run("ccphylo_tpu", args, tmp_path).stdout


@pytest.fixture(scope="module")
def float_phy(tmp_path_factory):
    """A seeded non-integer matrix of 30 taxa."""
    import numpy as np
    n = 30
    rng = np.random.RandomState(12)
    rows = [b"%10d" % n]
    for i in range(n):
        cells = [b"%.5f" % v for v in rng.uniform(0.5, 40.0, i)]
        rows.append(b"\t".join([b"t%02d" % i] + cells))
    f = tmp_path_factory.mktemp("fphy_torch") / "f.phy"
    f.write_bytes(b"\n".join(rows) + b"\n")
    return f


@pytest.mark.parametrize("method", ["dnj", "upgma", "nj"])
def test_tree_non_integer_matrix_default_is_the_host(float_phy, tmp_path,
                                                     method):
    """Non-integer cells in double precision: the default route runs the
    host engine, needs no torch device, and says so in one stderr line
    that names the variable which forces the card."""
    args = ["tree", "-m", method, "-i", str(float_phy)]
    ref = _run("ccphylo_tpu", args, tmp_path).stdout
    res = _run("ccphylo_tpu_torch", args, tmp_path,
               {"CCPHYLO_TORCH_DEVICE": "cuda"})
    assert res.stdout == ref and ref.endswith(b";\n")
    notes = [ln for ln in res.stderr.splitlines()
             if ln.startswith(b"# ccphylo_tpu_torch")]
    assert len(notes) == 1
    assert b"CCPHYLO_TORCH_ENGINE=device64" in notes[0]
    assert b"host engine" in notes[0]


@pytest.fixture(scope="module")
def miss_phy(tmp_path_factory):
    """A seeded integer matrix of 30 taxa, a tenth of its cells
    missing."""
    import numpy as np
    n = 30
    rng = np.random.RandomState(13)
    rows = [b"%10d" % n]
    for i in range(n):
        cells = [b"-1" if rng.rand() < 0.1 else b"%d" % rng.randint(1, 40)
                 for _ in range(i)]
        rows.append(b"\t".join([b"t%02d" % i] + cells))
    f = tmp_path_factory.mktemp("mphy_torch") / "m.phy"
    f.write_bytes(b"\n".join(rows) + b"\n")
    return f


@pytest.mark.parametrize("method", ["dnj", "hnj", "nj"])
def test_tree_missing_cells_default_is_the_host(miss_phy, tmp_path, method):
    """Integer cells with some missing, in double precision: the default
    route runs the host engine with one stderr line and needs no torch
    device; device64 runs the device engine, whose bytes on CPU tensors
    are the reference's under CCPHYLO_TPU_ENGINE=device64."""
    args = ["tree", "-m", method, "-i", str(miss_phy)]
    ref = _run("ccphylo_tpu", args, tmp_path).stdout
    res = _run("ccphylo_tpu_torch", args, tmp_path,
               {"CCPHYLO_TORCH_DEVICE": "cuda"})
    assert res.stdout == ref and ref.endswith(b";\n")
    notes = [ln for ln in res.stderr.splitlines()
             if ln.startswith(b"# ccphylo_tpu_torch")]
    assert len(notes) == 1 and b"missing cells" in notes[0]
    assert b"CCPHYLO_TORCH_ENGINE=device64" in notes[0]
    res = _run("ccphylo_tpu_torch", args, tmp_path,
               {"CCPHYLO_TORCH_ENGINE": "device64"})
    assert b"# ccphylo_tpu_torch" not in res.stderr
    assert res.stdout == _run("ccphylo_tpu", args, tmp_path,
                              {"CCPHYLO_TPU_ENGINE": "device64"}).stdout


def test_tree_non_integer_matrix_under_device64(float_phy, tmp_path):
    """device64 on non-integer cells, as the reference routes it: upgma
    runs the device engine (the reference's device64 bytes), nj falls to
    the host engine behind the float-scope guard with its note."""
    args = ["tree", "-m", "upgma", "-i", str(float_phy)]
    ref = _run("ccphylo_tpu", args, tmp_path,
               {"CCPHYLO_TPU_ENGINE": "device64"}).stdout
    res = _run("ccphylo_tpu_torch", args, tmp_path,
               {"CCPHYLO_TORCH_ENGINE": "device64"})
    assert res.stdout == ref and b"# ccphylo_tpu_torch" not in res.stderr
    cuda = _run("ccphylo_tpu_torch", args, tmp_path,
                {"CCPHYLO_TORCH_ENGINE": "device64",
                 "CCPHYLO_TORCH_DEVICE": "cuda"}, check=False)
    assert cuda.returncode != 0 or torch.cuda.is_available()
    args[2] = "nj"
    res = _run("ccphylo_tpu_torch", args, tmp_path,
               {"CCPHYLO_TORCH_ENGINE": "device64",
                "CCPHYLO_TORCH_DEVICE": "cuda"})  # never reached
    assert res.stdout == _run("ccphylo_tpu", args, tmp_path).stdout
    assert res.stderr.count(b"# ccphylo_tpu_torch: non-integer") == 1
    assert b"-m nj" in res.stderr


_INT = [3.0, 5.0, 7.0, 2.0, 4.0, 6.0]
_MISS = [3.0, -1.0, 7.0, 2.0, 4.0, 6.0]
_FLT = [3.5, 5.0, 7.0, 2.0, 4.0, 6.0]


@pytest.mark.parametrize("engine,flat,method,dtype,bs,route", [
    (None, _INT, "dnj", "b", 1.0, "packed"),
    (None, _MISS, "dnj", "b", 1.0, "exact"),
    (None, _INT, "dnj", "d", 1.0, "float64"),
    (None, _MISS, "dnj", "d", 1.0, "exact"),
    (None, _INT, "mn", "d", 1.0, "hclust/float64"),
    (None, _MISS, "ff", "d", 1.0, "exact"),
    ("device64", _MISS, "dnj", "d", 1.0, "float64"),
    ("device64", _MISS, "ff", "d", 1.0, "hclust/float64"),
    (None, _FLT, "upgma", "d", 1.0, "exact"),
    (None, _FLT, "dnj", "d", 1.0, "exact"),
    (None, _FLT, "dnj", "s", 1.0, "u16/float64"),
    (None, _FLT, "dnj", "s", 0.25, "u16/float64"),
    (None, _FLT, "dnj", "s", 1000.0, "exact"),
    (None, _MISS, "dnj", "s", 1.0, "exact"),
    (None, _INT, "nj", "s", 1.0, "exact"),
    (None, _INT, "dnj", "f", 1.0, "exact"),
    ("packed", _INT, "dnj", "b", 1.0, "packed"),
    ("packed", _INT, "dnj", "d", 1.0, "exact"),
    ("exact", _INT, "dnj", "b", 1.0, "exact"),
    ("device", _INT, "dnj", "d", 1.0, "float32"),
    ("device", _FLT, "dnj", "d", 1.0, "float32"),
    ("device", _INT, "dnj", "s", 1000.0, "u16/float32"),
    ("device", _INT, "cf", "d", 1.0, "hclust/float32"),
    ("device64", _INT, "dnj", "b", 3.0, "u8/float64"),
    ("device64", _MISS, "dnj", "b", 1.0, "exact"),
    ("device64", _INT, "dnj", "f", 1.0, "exact"),
    ("device64", _FLT, "cf", "d", 1.0, "hclust/float64"),
    ("device64", _FLT, "mn", "d", 1.0, "hclust/float64"),
    ("device64", _FLT, "hnj", "d", 1.0, "exact"),
    ("device64", _INT, "hnj", "d", 1.0, "hclust/float64"),
    ("device64", _INT, "upgma", "s", 1.0, "exact"),
    ("packed64", _INT, "dnj", "b", 1.0, "packed"),
    ("packed64", _MISS, "dnj", "b", 1.0, "exact"),
    ("packed64", _INT, "dnj", "d", 1.0, "exact"),
    ("sharded", _INT, "dnj", "d", 1.0, "sharded/dnj"),
    ("sharded", _MISS, "dnj", "d", 1.0, "sharded/dnj"),
    ("sharded", _FLT, "dnj", "d", 1.0, "sharded/dnj"),
    ("sharded", _INT, "nj", "d", 1.0, "sharded/nj"),
    ("sharded", _FLT, "upgma", "d", 1.0, "sharded/upgma"),
    ("sharded", _MISS, "nj", "d", 1.0, "exact"),
    ("sharded", _MISS, "upgma", "d", 1.0, "exact"),
    ("sharded", _INT, "hnj", "d", 1.0, "exact"),
    ("sharded", _INT, "dnj", "b", 1.0, "exact"),
    ("sharded", _INT, "nj", "f", 1.0, "exact")])
def test_route(monkeypatch, engine, flat, method, dtype, bs, route):
    """The routing table of tree_cmd._route, and which routes come with
    a note for stderr: the host engine standing in for a device engine
    on a double-precision matrix.  With the variable unset the card
    gets complete matrices only."""
    import numpy as np
    from ccphylo_tpu_torch.cli import tree_cmd
    if engine is None:
        monkeypatch.delenv("CCPHYLO_TORCH_ENGINE", raising=False)
    else:
        monkeypatch.setenv("CCPHYLO_TORCH_ENGINE", engine)
    *parts, note = tree_cmd._route(np.array(flat), method, dtype, bs)
    assert tree_cmd._engine_name(*parts) == route
    noted = route == "exact" and (engine == "sharded" or dtype == "d" and (
        flat is _FLT or (flat is _MISS and engine is None)))
    assert note.count("\n") == int(noted)
    assert ("forces the card" in note) == (noted and engine is None)


def test_port_imports_no_jax(kma_dir, tmp_path):
    """dist and tree of the port, in one process and on the default
    route, then phycmp and makespan, leave jax and the JAX package
    unimported."""
    (tmp_path / "jobs.tsv").write_bytes(b"#id\tsize\tcluster\n" + b"".join(
        b"%d\t%d\t%d\n" % (i, 7 * i % 11 + 1, i % 6) for i in range(20)))
    code = (
        "import sys\n"
        "from ccphylo_tpu_torch.cli.main import main\n"
        f"assert main(['dist', '-r', 'tpl1', '-f', '19', '-o', "
        f"{str(tmp_path / 'd.phy')!r}, '-i'] + {_fsas(kma_dir)!r}) == 0\n"
        f"assert main(['tree', '-m', 'dnj', '-b', '-i', "
        f"{str(tmp_path / 'd.phy')!r}, '-o', "
        f"{str(tmp_path / 't.nwck')!r}]) == 0\n"
        f"assert main(['tree', '-m', 'nj', '-i', "
        f"{str(tmp_path / 'd.phy')!r}, '-o', "
        f"{str(tmp_path / 'u.nwck')!r}]) == 0\n"
        f"assert main(['phycmp', '-i', {str(tmp_path / 'd.phy')!r}, "
        f"{str(tmp_path / 'd.phy')!r}, '-o', "
        f"{str(tmp_path / 'c.txt')!r}]) == 0\n"
        f"assert main(['makespan', '-i', {str(tmp_path / 'jobs.tsv')!r}, "
        f"'-o', {str(tmp_path / 'j.tsv')!r}, '-O', "
        f"{str(tmp_path / 'm.tsv')!r}]) == 0\n"
        "import ccphylo_tpu_torch.interop, ccphylo_tpu_torch.ops.build\n"
        "import ccphylo_tpu_torch.parallel.sharded_dnj\n"
        "import ccphylo_tpu_torch.parallel.sharded_nj\n"
        "import ccphylo_tpu_torch.utils.timing\n"
        "import ccphylo_tpu_torch.utils.checkpoint\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [k for k in sys.modules if k == 'ccphylo_tpu' "
        "or k.startswith('ccphylo_tpu.')]\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "CCPHYLO_TORCH_DEVICE": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         cwd=kma_dir, timeout=600, env=env)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    assert (tmp_path / "t.nwck").read_bytes().endswith(b";\n")
    assert (tmp_path / "c.txt").read_bytes()
    assert (tmp_path / "j.tsv").read_bytes()


def _imports(path):
    """Top-level package names imported anywhere in the file."""
    tree = ast.parse(path.read_text(), str(path))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add((node.module or "").split(".")[0])
    return found


def test_port_sources_import_no_jax_and_no_jax_package():
    files = sorted((REPO / "ccphylo_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    assert len(files) > 27
    assert {"torch_engine.py", "hclust_engine.py", "matdist_torch.py",
            "streamed_engine.py", "multihost.py", "sharded_nj.py",
            "sharded_dnj.py", "makespan.py", "distcmp.py",
            "newick_parse.py"} <= {f.name for f in files}
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "ccphylo_tpu"}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
    smoke = (REPO / "chip_smoke.py").read_text()
    assert '"ccphylo_tpu"' not in smoke  # starts no process of it either


def test_cuda_device_without_card_raises(kma_dir, monkeypatch):
    """With no CCPHYLO_TORCH_* variable set the port runs on the card,
    and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from ccphylo_tpu_torch.utils import torchconfig
    monkeypatch.delenv("CCPHYLO_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        torchconfig.device()
    res = _run("ccphylo_tpu_torch",
               ["dist", "-r", "tpl1", "-f", "17", "-i"] + _fsas(kma_dir),
               kma_dir, {"CCPHYLO_TORCH_DEVICE": None}, check=False)
    assert res.returncode != 0
    assert b"torch.cuda.is_available() is False" in res.stderr
    assert res.stdout == b""


def test_version_and_help_match_reference(tmp_path):
    for args in (["--version"], ["-v"], ["--help"], ["help"], [],
                 ["nosuchcommand"], ["dist", "-h"], ["tree", "-h"],
                 ["tree", "-M"], ["tree", "-F"], ["dist", "-D"],
                 ["dist", "-F"]):
        ours = _run("ccphylo_tpu_torch", args, tmp_path, check=False)
        ref = _run("ccphylo_tpu", args, tmp_path, check=False)
        assert (ours.returncode, ours.stdout, ours.stderr) \
            == (ref.returncode, ref.stdout, ref.stderr), args


# the subcommands that are host code in both packages
HOST_CMDS = ("dbscan", "union", "merge", "nwck2phy", "tsv2phy", "tsv2nwck",
             "rarify", "trim", "phycmp", "fullphy", "makespan", "seq2fasta")


@pytest.mark.parametrize("cmd", HOST_CMDS)
def test_subcommand_help_matches_reference(tmp_path, cmd):
    ours = _run("ccphylo_tpu_torch", [cmd, "-h"], tmp_path, check=False)
    ref = _run("ccphylo_tpu", [cmd, "-h"], tmp_path, check=False)
    assert (ours.returncode, ours.stdout, ours.stderr) \
        == (ref.returncode, ref.stdout, ref.stderr)
    assert ref.returncode == 0 and ref.stdout and ref.stderr == b""


@pytest.mark.parametrize("mode", ["dir", "stderr", "1"])
def test_profile_trace(kma_dir, tmp_path, mode):
    """CCPHYLO_TORCH_PROFILE=<dir> writes one torch.profiler Chrome trace
    there, with the program's spans in it, and still prints the phase
    report, spans nested in the fill included; stderr and 1 print the
    report only.  The trace's CUDA kernels are checked on the card
    (chip_smoke.py cli)."""
    import json
    prof = tmp_path / "prof"
    value = str(prof) if mode == "dir" else mode
    args = ["dist", "-r", "tpl1", "-f", "17", "-i"] + _fsas(kma_dir)
    res = _run("ccphylo_tpu_torch", args, kma_dir,
               {"CCPHYLO_TORCH_PROFILE": value})
    assert res.stdout == _run("ccphylo_tpu", args, kma_dir).stdout
    assert b"# --- ccphylo_tpu_torch profile ---" in res.stderr
    assert b"# phase dist/pairwise_fill: " in res.stderr
    assert b"# phase dist/stack: " in res.stderr
    assert b"profiler trace unavailable" not in res.stderr
    if mode != "dir":
        assert not prof.exists()
        return
    traces = list(prof.iterdir())
    assert [t.name for t in traces] == [
        t.name for t in prof.glob("ccphylo_tpu_torch.*.pt.trace.json")]
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert {"dist/pairwise_fill", "dist/stack", "dist/copy_back"} <= {
        e.get("name") for e in events if e.get("cat") == "user_annotation"}


@pytest.fixture(scope="module")
def caterpillar_phy(tmp_path_factory):
    """D_ij = |i - j| plus integer noise in [0, 2], 64 taxa: joins along
    a chain, so the fractional bits of the cells pile up with depth."""
    import numpy as np
    n = 64
    rng = np.random.RandomState(7)
    rows = [b"%10d" % n]
    for i in range(n):
        cells = [b"%d" % (i - j + rng.randint(0, 3)) for j in range(i)]
        rows.append(b"\t".join([b"c%02d" % i] + cells))
    f = tmp_path_factory.mktemp("cphy_torch") / "c.phy"
    f.write_bytes(b"\n".join(rows) + b"\n")
    return f


@pytest.mark.parametrize("method", ["dnj", "upgma"])
def test_tree_default_route_leaves_inexact_sums_to_the_host(
        caterpillar_phy, tmp_path, method):
    """A complete integer matrix goes to the float64 device engines by
    default, which track float64's exact range: dnj's row sums leave it
    on a caterpillar, and the run is handed to the host engine with one
    note; upgma stays on the device.  The bytes are the reference's
    either way; device64 keeps the card without a note."""
    args = ["tree", "-m", method, "-i", str(caterpillar_phy)]
    ref = _run("ccphylo_tpu", args, tmp_path).stdout
    res = _run("ccphylo_tpu_torch", args, tmp_path)
    assert res.stdout == ref and ref.endswith(b";\n")
    notes = [ln for ln in res.stderr.splitlines()
             if ln.startswith(b"# ccphylo_tpu_torch")]
    assert len(notes) == (method == "dnj")
    assert all(b"exact range" in ln and b"device64" in ln for ln in notes)
    res = _run("ccphylo_tpu_torch", args, tmp_path,
               {"CCPHYLO_TORCH_ENGINE": "device64"})
    assert b"# ccphylo_tpu_torch" not in res.stderr
