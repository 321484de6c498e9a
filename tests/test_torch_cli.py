"""The port's CLI (python -m ccphylo_tpu_torch) against the JAX package's
(python -m ccphylo_tpu), byte for byte, on the CPU, on every route:
`dist` on the torch path (the default; here CCPHYLO_TORCH_DEVICE=cpu,
so the plain versions) and on the host numpy kernels
(CCPHYLO_TORCH_DIST=host); `tree -m dnj -b` on the packed engine (the
default) and on the host exact engine (CCPHYLO_TORCH_ENGINE=exact).
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
    """CCPHYLO_TORCH_ENGINE=exact, and every method and dtype other
    than dnj -b under the default, run the port's host exact engine and
    need no torch device."""
    args = ["tree"] + targs + ["-i", str(phy)]
    ref = _run("ccphylo_tpu", args, tmp_path).stdout
    env = {"CCPHYLO_TORCH_DEVICE": "cuda"}  # never reached off dnj -b
    if engine:
        env["CCPHYLO_TORCH_ENGINE"] = engine
    elif targs == ["-m", "dnj", "-b"]:
        env["CCPHYLO_TORCH_DEVICE"] = "cpu"  # the packed engine's case
    ours = _run("ccphylo_tpu_torch", args, tmp_path, env).stdout
    assert ours == ref and ours.endswith(b";\n")


def test_tree_missing_cells_go_to_the_host_engine(tmp_path):
    """A matrix with missing cells cannot live in u8 storage: dnj -b
    runs the host engine, as in the reference."""
    f = tmp_path / "m.phy"
    f.write_bytes(b"         4\na\nb\t3\nc\t-1\t5\nd\t7\t4\t2\n")
    args = ["tree", "-m", "dnj", "-b", "-i", str(f)]
    ref = _run("ccphylo_tpu", args, tmp_path).stdout
    ours = _run("ccphylo_tpu_torch", args, tmp_path,
                {"CCPHYLO_TORCH_DEVICE": "cuda"}).stdout
    assert ours == ref and ours.endswith(b";\n")


@pytest.mark.parametrize("engine", ["device", "device64", "sharded",
                                    "nonsense"])
def test_unported_engine_is_an_argument_error(phy, tmp_path, engine):
    res = _run("ccphylo_tpu_torch", ["tree", "-m", "dnj", "-i", str(phy)],
               tmp_path, {"CCPHYLO_TORCH_ENGINE": engine}, check=False)
    assert res.returncode == 1 and res.stdout == b""
    assert b"CCPHYLO_TORCH_ENGINE" in res.stderr
    assert (b"ROADMAP.md" in res.stderr) == (engine != "nonsense")
    assert b"Traceback" not in res.stderr


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
    assert len(files) > 25
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
