"""Compile check and multi-process dry run of the port (counterpart of
the root module __graft_entry__.py of the JAX package: `entry` and
`dryrun_multichip`).

    python -m ccphylo_tpu_torch.dryrun [N]     # N ranks, 1 by default

builds the CUDA kernels, runs `entry()`'s SNP matrix, then
`dryrun_multichip(N)`: N rank processes that each run the seven stages
of `run_stages` at tiny shapes through every device engine of the port,
its sharded engines included, and prints one line per stage with its
seconds.  It runs on the card unless CCPHYLO_TORCH_DEVICE=cpu is set
(gloo between the ranks, the plain PyTorch versions of the kernels),
and raises without a card otherwise.  Any failed check, rank or time
limit exits non-zero.

The inputs are those of the JAX module, drawn with the same numpy calls
in the same order, so each stage can be held against the JAX function
of the same stage.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .ops import build, snp_torch
from .parallel import multihost, sharded_dnj, sharded_nj
from .tree import hclust_engine, packed_engine, streamed_engine, torch_engine
from .tree.torch_engine import _host
from .utils.torchconfig import device as default_device

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the stages of `run_stages`, in order
STAGES = ("sharded_snp", "dnj", "sharded_nj", "sharded_dnj", "hclust",
          "packed", "streamed")
NJ_METHODS = ("nj", "upgma")
HCLUST_METHODS = ("upgma", "hnj", "mn")
PACKED_RECORDS = ("I", "J", "DIJ2", "SDI2", "SDJ2", "d_last2")
TIMEOUT = 300.0  # seconds a dry run may take, process start included


def _require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(f"dry run: {what}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _draw_seqs(rng, n: int, W: int):
    """(n, W) random u32 words and the all-included pair mask."""
    seqs = rng.randint(0, 2**32, size=(n, W), dtype=np.uint64) \
        .astype(np.uint32)
    return seqs, np.full(W, 0x55555555, np.uint32)


def _draw_u8(rng, n: int, npad: int) -> np.ndarray:
    """(npad, npad) u8 matrix, its n active taxa random in [0, 200)."""
    qv = rng.randint(0, 200, n * (n - 1) // 2).astype(np.uint8)
    Dq = np.zeros((npad, npad), np.uint8)
    iu = np.tril_indices(n, -1)
    Dq[(iu[0], iu[1])] = qv
    Dq[(iu[1], iu[0])] = qv
    return Dq


def entry(device=None):
    """(fn, args): the all-pairs SNP counts of 32 random samples of 64
    words (1024 bases) under the all-included pair mask, on `device`
    (default: utils/torchconfig.device()).  On a card the kernels are
    built first, so `fn(*args)` launches `snp_expand_shared` and the
    int8 Gram."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        build.build_all()
    seqs, pairmask = _draw_seqs(np.random.RandomState(0), 32, 64)
    return snp_torch.snp_matrix, (snp_torch.u32_tensor(seqs, dev),
                                  snp_torch.u32_tensor(pairmask, dev))


def run_stages() -> dict:
    """This rank's seven stages, in the default process group of
    parallel/multihost.py::row_axis(), on utils/torchconfig.device().

    The inputs are drawn from one RandomState(0): the (4 * world, 32)
    sequence words, then stage 6's matrix, then stage 7's.  Each stage
    checks what the JAX stage asserts.  Returns numpy arrays: the
    inputs ("in/..."), every stage's records ("s<k>/..."), the seconds
    of each stage ("seconds/<stage>") and this process's kernel
    launches ("launches/<kernel>")."""
    dev = default_device()
    world = multihost.row_axis()[1]
    build.reset_launches()
    rng = np.random.RandomState(0)
    n = 4 * world
    seqs, pm = _draw_seqs(rng, n, 32)
    out = {"world": np.int32(world), "in/seqs": seqs, "in/pm": pm}
    secs = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        secs[name] = time.perf_counter() - t0

    def s1():  # sample-sharded SNP matrix, equal to the one-rank matrix
        s, p = snp_torch.u32_tensor(seqs, dev), snp_torch.u32_tensor(pm, dev)
        out["s1/D"] = _host(snp_torch.sharded_snp_matrix(s, p))
        out["s1/D_single"] = _host(snp_torch.snp_matrix(s, p))
        _require(out["s1/D"].shape == (n, n), "SNP matrix shape")
        _require(np.array_equal(out["s1/D"], out["s1/D_single"]),
                 "sharded SNP matrix == snp_matrix")

    stage("sharded_snp", s1)
    D = out["s1/D"]
    # the JAX stage pads rows to a multiple of the mesh (-1 cells)
    npad = -(-128 // world) * world
    Dsq = np.full((npad, npad), -1.0, np.float32)
    Dsq[:n, :n] = D.astype(np.float32)
    np.fill_diagonal(Dsq[:n, :n], 0.0)
    out["in/Dsq"] = Dsq
    Dfull = D.astype(np.float64)
    np.fill_diagonal(Dfull, 0.0)

    def s2():  # device DNJ, float32: one dnj_segment_float launch on the
        # card (its batch scan takes the JAX default's sequential
        # scan's trajectory, join for join)
        rec = torch_engine.dnj_joins(torch.from_numpy(Dsq.copy()).to(dev),
                                     n)
        for k, v in zip(("I", "J", "LI", "LJ", "d_last"), rec[:5]):
            out["s2/" + k] = _host(v)
        _require((out["s2/I"][:n - 2] > 0).all(), "DNJ joins recorded")

    def s3():  # sharded NJ and UPGMA
        for meth in NJ_METHODS:
            rec = sharded_nj.sharded_join_records(Dfull, n, method=meth)
            for k, v in zip(("I", "J", "LI", "LJ", "a", "b", "d_last"), rec):
                out[f"s3/{meth}/{k}"] = _host(v)
            _require(len(rec[0]) == n - 2 and rec[4] != rec[5],
                     f"sharded {meth} joins recorded")

    def s4():  # sharded DNJ, float32
        rec = sharded_dnj.sharded_dnj_records(Dfull, n)
        for k, v in zip(("I", "J", "LI", "LJ", "d_last"), rec):
            out["s4/" + k] = _host(v)
        _require((out["s4/I"][:n - 2] > 0).all(), "sharded DNJ joins")

    def s5():  # hclust-family engines on stage 2's matrix
        for meth in HCLUST_METHODS:
            rec = hclust_engine.hclust_joins(
                torch.from_numpy(Dsq.copy()).to(dev), n, method=meth)
            for k, v in zip(("I", "J", "LI", "LJ", "d_last"), rec[:5]):
                out[f"s5/{meth}/{k}"] = _host(v)
            _require(out[f"s5/{meth}/I"][0] > 0, f"hclust {meth} joins")

    for name, fn in zip(STAGES[1:5], (s2, s3, s4, s5)):
        stage(name, fn)

    npk = 40
    Dq = _draw_u8(rng, npk, packed_engine.pad_packed(npk))
    nst = 512
    Dq2 = _draw_u8(rng, nst, nst)
    out["in/Dq"], out["in/Dq2"] = Dq, Dq2

    def s6():  # packed exact-int32 engine (dnj_segment)
        rec = packed_engine.dnj_joins_packed(
            packed_engine.pack_words(Dq.copy(), dev), npk)
        for k, v in zip(PACKED_RECORDS, rec[:6]):
            out["s6/" + k] = _host(v)
        _require((out["s6/I"][:npk - 2] > 0).all(), "packed joins")

    def s7():  # row-cache engine (qrow_mins through slots) == packed
        rs = streamed_engine.dnj_joins_streamed(
            Dq2.copy(), nst, X=384, F=64, kbatch=32, device=dev)
        rp = packed_engine.dnj_joins_packed(
            packed_engine.pack_words(Dq2.copy(), dev), nst)
        for k, a, b in zip(PACKED_RECORDS, rs[:6], rp[:6]):
            out["s7/streamed/" + k], out["s7/packed/" + k] = _host(a), _host(b)
            _require(np.array_equal(out["s7/streamed/" + k],
                                    out["s7/packed/" + k]),
                     f"streamed == packed records ({k})")

    stage("packed", s6)
    stage("streamed", s7)
    out.update({"seconds/" + k: np.float64(v) for k, v in secs.items()})
    out.update({"launches/" + k: np.int64(v)
                for k, v in build.launches.items()})
    return out


def records(res: dict) -> dict:
    """The inputs and records of a `run_stages` result: what every rank,
    and every device, must agree on."""
    return {k: v for k, v in res.items()
            if not k.startswith(("seconds/", "launches/"))}


def _rank_env(dev: torch.device, world: int, rank: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "CCPHYLO_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [_REPO, os.environ.get("PYTHONPATH")]))
    env["CCPHYLO_TORCH_DEVICE"] = dev.type
    if dev.type == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    if world > 1:
        env.update(CCPHYLO_TORCH_COORDINATOR=f"127.0.0.1:{port}",
                   CCPHYLO_TORCH_NUM_PROCS=str(world),
                   CCPHYLO_TORCH_PROC_ID=str(rank))
    return env


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def dryrun_multichip(n: int, timeout: float = TIMEOUT, device=None) -> dict:
    """Run `run_stages` in n rank processes (`python -m
    ccphylo_tpu_torch.dryrun` in its rank mode) and return rank 0's
    result once every rank's records are equal.

    `device` (default: utils/torchconfig.device()) is passed to the
    ranks as CCPHYLO_TORCH_DEVICE: on ``cpu`` the ranks join a gloo
    group, on ``cuda`` an NCCL group with one card per rank, and n above
    the card count raises before any process starts.  World 1 declares
    no group (the ranks' `row_axis` makes one of one rank).  A rank that
    exits non-zero, or the time limit, stops every rank and raises."""
    dev = default_device() if device is None else torch.device(device)
    if n < 1:
        raise ValueError(f"need at least one rank, not {n}")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if n > cards:
            raise ValueError(
                f"a dry run of {n} ranks on cuda needs {n} cards, this "
                f"machine has {cards}: NCCL runs one rank per card")
        build.build_all()  # once here, not in every rank
    deadline = time.monotonic() + timeout
    port = multihost._free_port()
    with tempfile.TemporaryDirectory(prefix="ccphylo_dryrun_") as tmp:
        procs = []
        try:
            for r in range(n):
                with open(os.path.join(tmp, f"rank{r}.log"), "wb") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "ccphylo_tpu_torch.dryrun",
                         "--rank-out", tmp, "--timeout", str(timeout)],
                        env=_rank_env(dev, n, r, port),
                        stdout=log, stderr=subprocess.STDOUT))
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed:
                    r = failed[0]
                    with open(os.path.join(tmp, f"rank{r}.log"), "rb") as fh:
                        log = fh.read().decode(errors="replace")
                    raise RuntimeError(f"dry run: rank {r} of {n} exited "
                                       f"{codes[r]}:\n{log[-4000:]}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"dry run: {n} ranks still running "
                                       f"after {timeout} s")
                time.sleep(0.05)
        finally:
            _stop(procs)
        results = []
        for r in range(n):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                results.append({k: z[k] for k in z.files})
    ref = records(results[0])
    for r, res in enumerate(results[1:], 1):
        ours = records(res)
        _require(ours.keys() == ref.keys()
                 and all(np.array_equal(ref[k], ours[k]) for k in ref),
                 f"rank {r}'s records equal rank 0's")
    return results[0]


def _rank_main(out_dir: str, timeout: float) -> None:
    multihost.maybe_init_distributed(timeout=timeout)
    res = run_stages()
    np.savez(os.path.join(out_dir, f"rank{torch.distributed.get_rank()}.npz"),
             **res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ccphylo_tpu_torch.dryrun",
        description="Build the kernels, run the SNP matrix of entry() and "
                    "the seven stages of the dry run in N rank processes.")
    ap.add_argument("n", nargs="?", type=int, default=1,
                    help="ranks (default 1; one card each on cuda)")
    ap.add_argument("--timeout", type=float, default=TIMEOUT,
                    help="seconds the ranks may take (default %(default)s)")
    ap.add_argument("--rank-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_out:
        _rank_main(args.rank_out, args.timeout)
        return 0
    dev = default_device()
    t0 = time.perf_counter()
    build_s = build.build_all() if dev.type == "cuda" else 0.0
    print(f"build: {build_s:.3f} s")
    t = time.perf_counter()
    fn, fargs = entry(dev)
    D = fn(*fargs)
    _sync(dev)
    print(f"entry: snp_matrix {tuple(D.shape)} on {dev.type} in "
          f"{time.perf_counter() - t:.3f} s")
    res = dryrun_multichip(args.n, args.timeout, dev)
    for k, name in enumerate(STAGES, 1):
        print(f"stage {k} {name}: {float(res['seconds/' + name]):.3f} s")
    launched = {k[len("launches/"):]: int(v) for k, v in res.items()
                if k.startswith("launches/")}
    print("rank 0 kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in launched.items()))
    print(f"dryrun_multichip({args.n}) on {dev.type}: records equal on "
          f"every rank, {time.perf_counter() - t0:.3f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
