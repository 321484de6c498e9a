"""The port's CLI (python -m ccphylo_tpu_torch) against the JAX package's
(python -m ccphylo_tpu), byte for byte, on the CPU: `dist` through the
port's SNP seams and `tree -m dnj -b` on the port's packed engine.  Also:
the port imports no jax, and asking it for CUDA without a card
raises."""

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
    args = ["dist", "-r", template] + flags + ["-i"] + _fsas(kma_dir)
    jax_out = _run("ccphylo_tpu", args, kma_dir,
                   {"CCPHYLO_TPU_DIST": "device"}).stdout
    ours = _run("ccphylo_tpu_torch", args, kma_dir,
                {"CCPHYLO_TORCH_DIST": "device"}).stdout
    assert ours == jax_out
    if template == "tpl1":
        assert ours.count(b"\n") == 7  # size line + 6 rows


def test_tree_packed_matches_jax_packed(kma_dir, tmp_path):
    args = ["dist", "-r", "tpl1", "-f", "17", "-i"] + _fsas(kma_dir)
    phy = tmp_path / "d.phy"
    phy.write_bytes(_run("ccphylo_tpu", args, kma_dir).stdout)
    targs = ["tree", "-m", "dnj", "-b", "-i", str(phy)]
    jax_out = _run("ccphylo_tpu", targs, tmp_path,
                   {"CCPHYLO_TPU_ENGINE": "packed"}).stdout
    ours = _run("ccphylo_tpu_torch", targs, tmp_path,
                {"CCPHYLO_TORCH_ENGINE": "packed"}).stdout
    assert ours == jax_out and ours.endswith(b";\n")


def test_port_imports_no_jax(kma_dir, tmp_path):
    """dist and tree of the port, in one process, leave jax unimported."""
    code = (
        "import sys\n"
        "from ccphylo_tpu_torch.cli.main import main\n"
        f"assert main(['dist', '-r', 'tpl1', '-f', '19', '-o', "
        f"{str(tmp_path / 'd.phy')!r}, '-i'] + {_fsas(kma_dir)!r}) == 0\n"
        f"assert main(['tree', '-m', 'dnj', '-b', '-i', "
        f"{str(tmp_path / 'd.phy')!r}, '-o', "
        f"{str(tmp_path / 't.nwck')!r}]) == 0\n"
        "import ccphylo_tpu_torch.interop, ccphylo_tpu_torch.ops.build\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n")
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "CCPHYLO_TORCH_DEVICE": "cpu", "CCPHYLO_TORCH_DIST": "device",
           "CCPHYLO_TORCH_ENGINE": "packed"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         cwd=kma_dir, timeout=600, env=env)
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    assert (tmp_path / "t.nwck").read_bytes().endswith(b";\n")


def test_cuda_device_without_card_raises(kma_dir, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from ccphylo_tpu_torch.utils import torchconfig
    monkeypatch.setenv("CCPHYLO_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        torchconfig.device()
    res = _run("ccphylo_tpu_torch",
               ["dist", "-r", "tpl1", "-f", "17", "-i"] + _fsas(kma_dir),
               kma_dir, {"CCPHYLO_TORCH_DIST": "device",
                         "CCPHYLO_TORCH_DEVICE": "cuda"}, check=False)
    assert res.returncode != 0
    assert b"torch.cuda.is_available() is False" in res.stderr
    assert res.stdout == b""


def test_host_subcommands_are_delegated(tmp_path):
    ours = _run("ccphylo_tpu_torch", ["--version"], tmp_path).stdout
    ref = _run("ccphylo_tpu", ["--version"], tmp_path).stdout
    assert ours == ref
