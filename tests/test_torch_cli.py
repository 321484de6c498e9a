"""The port's CLI (python -m ccphylo_tpu_torch) against the JAX package's
(python -m ccphylo_tpu), byte for byte, on the CPU, on every route:
`dist` on the torch path (the default; here CCPHYLO_TORCH_DEVICE=cpu,
so the plain versions) and on the host numpy kernels
(CCPHYLO_TORCH_DIST=host); `tree` on every route of
CCPHYLO_TORCH_ENGINE: unset (-m dnj -b on the packed engine, integer
matrices of every method and -m dnj -s on the float64 device engines,
the rest on the host), device, device64, packed and exact.
Also: the port imports no jax and nothing of the JAX package, runs on
the card unless asked for the CPU (and raises without a card), prints
the reference's version and help, and refuses what is not ported."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from ccphylo_tpu_torch.cli.main import UNPORTED

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


def test_dist_mat_input_runs_host_metrics(kma_dir):
    """.mat input runs the host metrics whatever CCPHYLO_TORCH_DIST is."""
    mats = sorted(os.path.basename(p)
                  for p in glob.glob(str(kma_dir / "*.mat.gz")))
    args = ["dist", "-r", "tpl1", "-d", "cos", "-i"] + mats
    ref = _run("ccphylo_tpu", args, kma_dir)
    ours = _run("ccphylo_tpu_torch", args, kma_dir)
    assert ours.stdout == ref.stdout and ours.stderr == ref.stderr
    assert ours.stdout.count(b"\n") == 7


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


@pytest.mark.parametrize("engine", ["sharded", "nonsense"])
def test_unported_engine_is_an_argument_error(phy, tmp_path, engine):
    res = _run("ccphylo_tpu_torch", ["tree", "-m", "dnj", "-i", str(phy)],
               tmp_path, {"CCPHYLO_TORCH_ENGINE": engine}, check=False)
    assert res.returncode == 1 and res.stdout == b""
    assert b"CCPHYLO_TORCH_ENGINE" in res.stderr
    assert (b"ROADMAP.md" in res.stderr) == (engine != "nonsense")
    assert b"Traceback" not in res.stderr


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
                          (["-m", "upgma"], "device")):
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
    ("device64", _INT, "upgma", "s", 1.0, "exact")])
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
    noted = dtype == "d" and route == "exact" and (
        flat is _FLT or (flat is _MISS and engine is None))
    assert note.count("\n") == int(noted)
    assert ("forces the card" in note) == (noted and engine is None)


def test_port_imports_no_jax(kma_dir, tmp_path):
    """dist and tree of the port, in one process and on the default
    route, leave jax and the JAX package unimported."""
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
        "import ccphylo_tpu_torch.interop, ccphylo_tpu_torch.ops.build\n"
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
    assert {"torch_engine.py", "hclust_engine.py"} \
        <= {f.name for f in files}
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


@pytest.mark.parametrize("cmd", UNPORTED)
def test_unported_subcommand_is_refused(tmp_path, cmd):
    res = _run("ccphylo_tpu_torch", [cmd, "-h"], tmp_path, check=False)
    assert res.returncode != 0 and res.stdout == b""
    assert res.stderr.count(b"\n") == 1
    assert cmd.encode() in res.stderr and b"not ported" in res.stderr
