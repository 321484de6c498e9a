"""Ranks as real processes for the tests of the port's sharded engines
(ccphylo_tpu_torch/parallel/): `launch` starts one gloo job per world
size, all at once, over tcp://127.0.0.1; each rank runs every job of a
list and writes what it got to ``<out>/w<world>/rank<r>.npz``.

World 1 runs with no CCPHYLO_TORCH_* process variable (the engines make
their own one-rank group); larger worlds are started through
CCPHYLO_TORCH_COORDINATOR / _NUM_PROCS / _PROC_ID.

Run as a script, this file is one rank: ``python torch_ranks.py
<jobs.json> <out dir>``, with the arrays of the jobs in jobs.npz beside
the list.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "CCPHYLO_"))}
    env.update(PYTHONPATH=str(REPO), CCPHYLO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def start(tmp: Path, jobs: list, arrays: dict, worlds=(1, 2, 4)):
    """Start the ranks of every world on `jobs` (dicts with a "name" and
    a "kind", see `_run_job`; arrays under "<name>/<key>").  Returns the
    running processes, for `wait`."""
    np.savez(tmp / "jobs.npz", **arrays)
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    procs = []
    for w in worlds:
        port = _free_port()
        out = tmp / f"w{w}"
        out.mkdir()
        for r in range(w):
            extra = {} if w == 1 else {
                "CCPHYLO_TORCH_COORDINATOR": f"127.0.0.1:{port}",
                "CCPHYLO_TORCH_NUM_PROCS": str(w),
                "CCPHYLO_TORCH_PROC_ID": str(r)}
            procs.append((w, r, subprocess.Popen(
                [sys.executable, __file__, str(tmp / "jobs.json"), str(out)],
                env=_env(extra), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)))
    return procs


def wait(tmp: Path, procs, timeout: float = 400.0) -> dict:
    """{world: [rank 0's results, rank 1's, ...]} once every rank has
    exited 0; kills them all and raises otherwise."""
    deadline = time.monotonic() + timeout
    try:
        for w, r, p in procs:
            _, err = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            if p.returncode != 0:
                raise AssertionError(f"world {w} rank {r} exited "
                                     f"{p.returncode}:\n"
                                     + err.decode(errors="replace"))
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    worlds = sorted({w for w, _, _ in procs})
    return {w: [dict(np.load(tmp / f"w{w}" / f"rank{r}.npz"))
                for r in range(w)] for w in worlds}


def _run_job(job: dict, a: dict) -> dict:
    import torch
    from ccphylo_tpu_torch import interop
    from ccphylo_tpu_torch.io.qseqs import Name
    from ccphylo_tpu_torch.ops import snp_torch
    from ccphylo_tpu_torch.parallel import sharded_dnj, sharded_nj

    kind, n = job["kind"], job.get("n")
    f64 = torch.float64
    if kind == "dnj":
        old, sharded_dnj.KBATCH = sharded_dnj.KBATCH, job.get(
            "kbatch", sharded_dnj.KBATCH)
        records = sharded_dnj.sharded_dnj_records
        out = {}

        def recording(*args, **kw):  # the records under build_tree_...
            res = records(*args, **kw)
            out.update(zip(("I", "J", "LI", "LJ", "d_last"), res))
            return res

        try:
            if job.get("newick"):
                sharded_dnj.sharded_dnj_records = recording
                names = [Name(b"t%03d" % i, 32) for i in range(n)]
                flat = a["D"][np.tril_indices(n, -1)]
                nwk = sharded_dnj.build_tree_sharded_dnj(flat, n, names,
                                                         dtype=f64)
                out["newick"] = np.frombuffer(nwk, np.uint8)
            else:
                recording(a["D"], n, f64)
        finally:
            sharded_dnj.KBATCH = old
            sharded_dnj.sharded_dnj_records = records
        return out
    if kind == "handover":
        rank, world = torch.distributed.get_rank(), \
            torch.distributed.get_world_size()
        state = [a[f"s{k}"] for k in range(10)]
        st = interop.sharded_state_from_jax(state, rank, world)
        st = sharded_dnj.dnj_segment(st, job["t"], n - 2, n)
        return dict(zip(("I", "J", "LI", "LJ", "d_last"),
                        sharded_dnj.dnj_records(st)))
    if kind == "nj":
        res = sharded_nj.sharded_join_records(a["D"], n, job["method"], f64)
        return dict(zip(("I", "J", "LI", "LJ", "a", "b", "d_last"), res))
    if kind == "snp":
        D = snp_torch.sharded_snp_matrix(torch.from_numpy(a["seqs"]),
                                         torch.from_numpy(a["pm"]),
                                         wchunk=job["wchunk"])
        return {"D": D.numpy()}
    raise ValueError(kind)


def _main(jobs_path: str, out_dir: str) -> None:
    import torch
    torch.set_num_threads(1)
    from ccphylo_tpu_torch.parallel import multihost

    first = multihost.maybe_init_distributed()
    rank, world = multihost.row_axis()
    again = multihost.maybe_init_distributed()  # a repeated call: no-op
    out = {"group": np.array([first, again, rank, world,
                              torch.distributed.get_world_size()])}
    jobs = json.loads(Path(jobs_path).read_text())
    with np.load(Path(jobs_path).with_suffix(".npz")) as z:
        arrays = {k: z[k] for k in z.files}
    for job in jobs:
        pre = job["name"] + "/"
        a = {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}
        for k, v in _run_job(job, a).items():
            out[pre + k] = np.asarray(v)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _main(*sys.argv[1:3])
