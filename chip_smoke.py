"""On-chip smoke run of the PyTorch/CUDA port (ccphylo_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py        # from the root of a checkout, one card

It imports only the port: no JAX, nothing of the JAX package, and it
starts no process of it.  Its oracles are the port's plain PyTorch
version of each kernel and the port's host numpy code (ops/snp.py,
tree/exact.py, the CLI under CCPHYLO_TORCH_DIST=host
CCPHYLO_TORCH_ENGINE=exact).  Phases, in order; any failure raises and
exits non-zero, no exception is caught:

1. build: compile the CUDA kernels from ccphylo_tpu_torch/csrc (nvcc,
   sm_90a, one process per source, in parallel);
2. kernels: hold each kernel bit-exactly against its plain version on
   the card, at the main path's shapes, and time both.  The fused scan
   `dnj_scan` is held against `dnj_scan_plain` here on an all-tie
   matrix, and in phases 3 and 4 on every join of a real run's prefix
   (`CheckedScan`), where it is also timed;
3. main path: n = 2048 isolates of L = 1 Mbp, a clonal outbreak
   generated on the card from a seed, through the port's CLI seams on
   the host arrays the CLI hands them: `dist` (dist_cmd._batch_shared
   and _batch_pairwise; rows checked against the host numpy kernels)
   into `tree -m dnj -b` (tree_cmd._dispatch_build on the packed
   engine, one dnj_scan launch per join; Newick checked against the
   host-driven passes over qrow_mins, the plain-scan run and the host
   exact -b engine).  The launch counts of the `kernels` line are this
   phase's: the counters are set to 0 just before each path and read
   just after it.  The fused and the passes scan are timed back to
   back (fused, passes, passes, fused), each with its passes, its
   kernel launches and the share of the wall time spent in the scan;
4. at scale: n = 32768 isolates of 100 kbp from the same outbreak
   model, through `dist` into the packed engine (a 1 GiB u8 matrix);
   dist rows are checked against the host kernels and the first joins
   against a plain-scan run;
5. engines: the float64 device engines of all seven tree methods
   (tree/torch_engine.py, tree/hclust_engine.py) on phase 3's integer
   SNP matrix as a double-precision matrix, through
   tree_cmd._dispatch_build with no variable set: each Newick
   byte-equal to the host exact engine's, the engine that ran
   asserted, joins/s printed.  Then dnj on u16 cells (-s) and on u8
   cells (`device64` -b), both byte-equal to the host engine; dnj,
   upgma, cf and hnj on a matrix of random integers in [0, 25), far
   from additive and dense in ties, byte-equal too; the same with 12%
   of the cells missing (the default route goes to the host with its
   note; `device64` runs on the card, equality printed); dnj on
   float32 state (`device`; shape only, agreement with the float64
   run printed); how many of float64's 53 bits the cells and row sums
   of the SNP and the random run used (`exact_range`: every sum must
   be exact); a non-integer copy of the SNP matrix (the default route
   goes to the host with its note, `device64` -m upgma runs on the
   card); and dnj in float64 at n = 8192 from phase 4's outbreak
   model, timed, byte-equal to the host exact engine.  The host
   engine's runs are made in worker processes after the card's timed
   runs, but for the one at n = 8192, which takes minutes and runs in
   one worker beside them;
6. CLI: python -m ccphylo_tpu_torch dist, tree -m dnj -b, tree -m nj
   and tree -m dnj on make_dataset files, on the card by default,
   byte-equal to the same commands on the host code.

`python3 chip_smoke.py kernels main_path` runs the build and only the
named phases (kernels, main_path, scale, engines, cli, profile) and
prints their results without the contract lines: for work on one
phase.  `profile` runs only when named: 64 joins of each device engine
at n = 2048 on the host's clock and the next 64 in a torch.profiler
window, for kernel launches, host reads, device time and the device's
idle share per join.

The last two lines are the `kernels` JSON and the contract line
{"ok": true, "device": {...}}; before them, the card's name and power
limit as nvidia-smi reports them.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ccphylo_tpu_torch.cli import dist_cmd, tree_cmd
from ccphylo_tpu_torch.io.qseqs import Name
from ccphylo_tpu_torch.ops import build, scan, snp, snp_torch
from ccphylo_tpu_torch.tree.exact import build_tree
from ccphylo_tpu_torch.tree import hclust_engine as he
from ccphylo_tpu_torch.tree import packed_engine as pe
from ccphylo_tpu_torch.tree import segmenting
from ccphylo_tpu_torch.tree import torch_engine as te

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
N_DIST, L_DIST = 2048, 1_000_000
N_SCALE, L_SCALE = 32768, 100_000
N_DEPTH = 8192       # the float64 DNJ engine's run at depth
PROFILE_JOINS = 64   # joins under torch.profiler in the `profile` phase
TREE_METHODS = ("dnj", "upgma", "ff", "cf", "hnj", "nj", "mn")
RANDOM_METHODS = ("dnj", "upgma", "cf", "hnj")  # run on the random matrix
MISSING_METHODS = ("dnj", "upgma")  # run on the matrix with missing cells
EXP_ROWS, EXP_WORDS = 2048, 2048  # one genome chunk of the main path
PREFIX_JOINS = 1024  # plain-scan check of the phase-4 run
CHECKED_JOINS = 256  # joins of a run on which dnj_scan is held to plain
KBATCH = 128         # candidate rows per scan pass (the engine's default)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_META = {
    "snp_expand_shared": ("ccphylo_tpu_torch/csrc/snp_expand.cu",
                          "ccphylo_tpu/ops/snp_pallas.py:69"),
    "snp_expand_pairwise": ("ccphylo_tpu_torch/csrc/snp_expand.cu",
                            "ccphylo_tpu/ops/snp_pallas.py:80"),
    "qrow_mins": ("ccphylo_tpu_torch/csrc/qrow_mins.cu",
                  "ccphylo_tpu/ops/scan_pallas.py:49"),
    "dnj_scan": ("ccphylo_tpu_torch/csrc/dnj_scan.cu",
                 "ccphylo_tpu/ops/scan_pallas.py:49"),
}


def log(*a):
    print("#", *a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` calls (warm).  The
    calls are queued behind a spin of some milliseconds, so that a
    kernel shorter than its launch is timed on the device and not by
    the pace of the host that enqueues it."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(xs, ys) -> int:
    err = 0
    for x, y in zip(xs, ys):
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bytes_ms(nbytes: float) -> float:
    """Least milliseconds the card needs to move `nbytes` to or from
    device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def scan_bytes(rows: torch.Tensor, nq: int) -> int:
    """Bytes a scan over the candidate `rows` must move: the c < r
    prefix of each row (one byte a cell), the sd2 entries under the
    longest prefix, `nq` cached Q entries, and per row its index and the
    two results."""
    r = rows[rows >= 1].long()
    longest = int(r.max()) if r.numel() else 0
    return int(r.sum()) + 4 * longest + 4 * nq + 12 * r.numel()


class CheckedScan:
    """A batch scan for pe.SCANS that holds `dnj_scan` against
    `dnj_scan_plain` on every join it is given, bit for bit (result, Q
    and P).  With `timed`, it also times both on the first join of each
    kind: no pass, one pass, several passes."""

    KINDS = ("zero passes", "one pass, fewer than K", "several passes")

    def __init__(self, timed=False):
        self.timing = timed
        self.joins = 0
        self.err = 0
        self.kinds = dict.fromkeys(self.KINDS, 0)
        self.timed = []  # dicts: join, passes, rows, ms, plain_ms, bound_ms

    def __call__(self, words, sD2, Q, P, seed, m_t, co, K):
        scanned = []

        def recording(rows, co, words, sd2):
            scanned.append(rows)
            return scan.qrow_mins_plain(rows, co, words, sd2)

        # dnj_scan_plain, with the rows of each pass noted for the bound
        Qp, Pp = Q.clone(), P.clone()
        ref = scan.dnj_scan_passes(words, sD2, Qp, Pp, seed, m_t, co, K,
                                   qrow=recording)
        npass = int(ref[2])
        kind = self.KINDS[min(npass, 2)]
        if self.timing and not self.kinds[kind]:
            rows = torch.cat(scanned) if scanned else Q.new_zeros(0)
            self._time(rows, npass, words, sD2, Q, P, seed, m_t, co, K)
        res = scan.dnj_scan(words, sD2, Q, P, seed, m_t, co, K)
        err = max_abs_err((res, Q, P), (ref, Qp, Pp))
        self.err = max(self.err, err)
        assert err == 0, f"dnj_scan differs from its plain version at " \
                         f"join {self.joins}: {res.tolist()} {ref.tolist()}"
        self.kinds[kind] += 1
        self.joins += 1
        return res

    def _time(self, rows, npass, words, sD2, Q, P, seed, m_t, co, K):
        reps = 20
        copies = [(Q.clone(), P.clone()) for _ in range(2 * (reps + 1))]
        it = iter(copies)
        ms = cuda_ms(lambda: scan.dnj_scan(words, sD2, *next(it), seed,
                                           m_t, co, K), reps)
        plain = cuda_ms(lambda: scan.dnj_scan_plain(
            words, sD2, *next(it), seed, m_t, co, K), reps)
        self.timed.append({
            "join": self.joins, "m_t": m_t, "passes": npass,
            "rows": int((rows >= 1).sum()), "ms": ms, "plain_ms": plain,
            "bound_ms": bytes_ms(scan_bytes(rows, m_t) + 16)})

    def summary(self) -> dict:
        k = max(len(self.timed), 1)
        return {"joins": self.joins, "max_abs_err": self.err,
                "kinds": self.kinds, "timed": self.timed,
                "ms": sum(t["ms"] for t in self.timed) / k,
                "plain_ms": sum(t["plain_ms"] for t in self.timed) / k,
                "bound_ms": sum(t["bound_ms"] for t in self.timed) / k}


class _Stop(Exception):
    pass


def run_prefix(words, n, joins, scan_name):
    """The first `joins` joins of the packed engine on `words` (updated
    in place); returns the join records so far as numpy arrays."""
    prefix = {}

    def stop(st, done, total):
        prefix.update({k: np.array(st[k]) for k in ("I", "J")})
        prefix.update({k: st[k].cpu().numpy() for k in
                       ("DIJ2", "SDI2", "SDJ2")})
        raise _Stop

    seg, segmenting.SEG = segmenting.SEG, joins
    try:
        pe.dnj_joins_packed(words, n, kbatch=KBATCH, hooks=stop,
                            scan=scan_name)
    except _Stop:
        pass
    finally:
        segmenting.SEG = seg
    return prefix


def checked_prefix(words8, n, joins, timed, res, key):
    """Hold dnj_scan against its plain version on the first `joins`
    joins of a real run on a copy of the byte matrix `words8`; with
    `timed`, the prefix must hold a join of each kind, and the first of
    each is timed."""
    chk = pe.SCANS["checked"] = CheckedScan(timed)
    try:
        run_prefix(words8.clone().view(torch.int32), n, joins, "checked")
    finally:
        del pe.SCANS["checked"]
    res[key] = s = chk.summary()
    assert s["joins"] == joins
    assert not timed or (all(s["kinds"].values())
                         and len(s["timed"]) == len(CheckedScan.KINDS)), s
    log(f"dnj_scan equals dnj_scan_plain on the first {joins} joins at "
        f"n={n}: {s['kinds']}")
    for t in s["timed"]:
        log(f"  join {t['join']}: {t['passes']} passes, {t['rows']} rows: "
            f"dnj_scan {t['ms']:.4f} ms, plain version "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms")
    return s


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions


def phase_kernels(dev, g, res):
    err = {k: 0 for k in KERNEL_META}
    bound = res["bound_ms"] = {}

    def rand_words(shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                             device=dev, generator=g)

    pair = 0x55555555
    # expansion: one chunk of the n=2048 main path, then a ragged n on a
    # column slice of a wider matrix (row stride != width)
    big = rand_words((EXP_ROWS, EXP_WORDS))
    pm = rand_words((EXP_WORDS,)) & pair
    masks = rand_words((EXP_ROWS, EXP_WORDS)) & pair
    nr, wr = EXP_ROWS // 2 - 24, EXP_WORDS // 2 - 247
    rag = rand_words((nr, EXP_WORDS))[:, 13:13 + wr]
    rag_m = (rand_words((nr, EXP_WORDS)) & pair)[:, 13:13 + wr]
    for s, p, m in ((big, pm, masks), (rag, pm[13:13 + wr], rag_m)):
        err["snp_expand_shared"] = max(err["snp_expand_shared"], max_abs_err(
            [snp_torch.expand_shared(s, p)],
            [snp_torch.expand_shared_plain(s, p)]))
        err["snp_expand_pairwise"] = max(
            err["snp_expand_pairwise"],
            max_abs_err(snp_torch.expand_pairwise(s, m),
                        snp_torch.expand_pairwise_plain(s, m)))
    t = res["kernel_ms"] = {}
    # bytes: the words (and masks) read once, the int8 planes written once
    nw = EXP_ROWS * EXP_WORDS
    bound["snp_expand_shared"] = bytes_ms(4 * nw + 4 * EXP_WORDS + 48 * nw)
    bound["snp_expand_pairwise"] = bytes_ms(8 * nw + 64 * nw)
    t["snp_expand_shared"] = (
        cuda_ms(lambda: snp_torch.expand_shared(big, pm), 20),
        cuda_ms(lambda: snp_torch.expand_shared_plain(big, pm), 5))
    t["snp_expand_pairwise"] = (
        cuda_ms(lambda: snp_torch.expand_pairwise(big, masks), 20),
        cuda_ms(lambda: snp_torch.expand_pairwise_plain(big, masks), 5))
    del big, masks, rag, rag_m

    # batch scan at n = 32768 (1 GiB matrix): random, padding, repeated,
    # all-tie rows
    n = N_SCALE
    words = rand_words((n, n // 4))
    sd2 = torch.randint(0, 1 << 20, (n,), dtype=torch.int32, device=dev,
                        generator=g)
    co = 2 * (n - 2)
    rows = torch.randint(1, n, (128,), dtype=torch.int32, device=dev,
                         generator=g)
    pad = rows.clone()
    pad[::3] = 0
    rep = rows[:16].repeat(8).contiguous()
    for r in (rows, pad, rep):
        err["qrow_mins"] = max(err["qrow_mins"], max_abs_err(
            scan.qrow_mins(r, co, words, sd2),
            scan.qrow_mins_plain(r, co, words, sd2)))
    t["qrow_mins"] = (cuda_ms(lambda: scan.qrow_mins(rows, co, words, sd2),
                              50),
                      cuda_ms(lambda: scan.qrow_mins_plain(rows, co, words,
                                                           sd2), 10))
    bound["qrow_mins"] = bytes_ms(scan_bytes(rows, 0))
    words.fill_(0x05050505)  # every cell 5: every column ties
    sd2.zero_()
    rmin, rarg = scan.qrow_mins(rows, 10, words, sd2)
    assert torch.equal(rarg, rows - 1) and bool((rmin == 50).all())
    err["qrow_mins"] = max(err["qrow_mins"], max_abs_err(
        (rmin, rarg), scan.qrow_mins_plain(rows, 10, words, sd2)))
    del words, sd2

    # the fused scan from an all-tie matrix (every cell 5, so every
    # cached Q ties): the whole engine run at n = 2048, then the first
    # joins at n = 32768, each join against the plain version
    for n, joins in ((N_DIST, N_DIST - 2), (N_SCALE, CHECKED_JOINS)):
        tie = torch.full((n, n), 5, dtype=torch.uint8, device=dev)
        tie.fill_diagonal_(0)
        s = checked_prefix(tie, n, joins, False, res, f"scan_check_ties_{n}")
        err["dnj_scan"] = max(err["dnj_scan"], s["max_abs_err"])
        del tie
    res["max_abs_err"] = err
    assert all(v == 0 for v in err.values()), err
    for k, (ms, plain) in t.items():
        log(f"kernel {k}: {ms:.4f} ms, plain version {plain:.4f} ms, "
            f"bound {bound[k]:.6f} ms, max_abs_err {err[k]}")


# ---------------------------------------------------------------------
# phase 3: dist -> tree at n = 2048, L = 1 Mbp


_SHIFTS = (torch.arange(16, dtype=torch.int64) * -2 + 30)


def pack2(vals: torch.Tensor) -> torch.Tensor:
    """(rows, L) values < 4 -> (rows, L/16) int32 words, position k of a
    word at bits (30-2k, 31-2k)."""
    r, L = vals.shape
    v = (vals.view(r, L // 16, 16).long()
         << _SHIFTS.to(vals.device)).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def outbreak(dev, g, n, L, per_sample=True):
    """Clonal outbreak: one random ancestor; isolate i descends from a
    random earlier isolate with Poisson(3) substitutions.  Returns 2-bit
    words (n, L/16) int32, a shared include mask (L,) bool and
    per-sample include masks (n, L) bool, each missing ~1% of
    positions (None unless per_sample)."""
    bases = torch.empty((n, L), dtype=torch.uint8, device=dev)
    bases[0] = torch.randint(0, 4, (L,), dtype=torch.uint8, device=dev,
                             generator=g)
    parent = (torch.rand(n, device=dev, generator=g)
              * torch.arange(n, device=dev)).long().tolist()
    nmut = torch.poisson(torch.full((n,), 3.0, device=dev),
                         generator=g).long()
    offs = [0] + torch.cumsum(nmut, 0).tolist()
    pos = torch.randint(0, L, (offs[-1],), device=dev, generator=g)
    delta = torch.randint(1, 4, (n,), dtype=torch.uint8, device=dev,
                          generator=g)
    for i in range(1, n):
        bases[i] = bases[parent[i]]
        p = pos[offs[i]:offs[i + 1]]
        bases[i, p] = (bases[i, p] + delta[i]) % 4
    seqs = torch.cat([pack2(bases[r0:r0 + 256])
                      for r0 in range(0, n, 256)])
    del bases
    shared = torch.randint(0, 100, (L,), dtype=torch.uint8, device=dev,
                           generator=g) != 0
    inc = None
    if per_sample:
        inc = torch.randint(0, 100, (n, L), dtype=torch.uint8, device=dev,
                            generator=g) != 0
    return seqs, shared, inc


def host_u64(seqs32: torch.Tensor) -> np.ndarray:
    w = seqs32.cpu().numpy().view(np.uint32)
    w = w.reshape(w.shape[0], -1, 2).astype(np.uint64)
    return (w[..., 0] << np.uint64(32)) | w[..., 1]


def host_inc32(inc: torch.Tensor) -> np.ndarray:
    """(.., L) bool -> (.., L/32) u32 include words, position k of a word
    at bit 31-k."""
    b = np.packbits(inc.cpu().numpy(), axis=-1, bitorder="big")
    return b.view(">u4").astype(np.uint32)


def phase_main_path(dev, g, res):
    """dist -> tree through the port's CLI seams, on the host arrays the
    CLI hands them: dist_cmd._batch_shared / _batch_pairwise (u64
    sequences, u32 include words; host conversion, copy to the card,
    kernels, n x n copy back) and tree_cmd._dispatch_build with the
    packed engine."""
    n, L = N_DIST, L_DIST
    (seqs, shared_inc, inc), t = synced(lambda: outbreak(dev, g, n, L))
    log(f"outbreak n={n} L={L}: generated in {t:.1f} s")
    pm = pack2(shared_inc[None].to(torch.uint8))[0]
    s64 = host_u64(seqs)
    inc32_shared = host_inc32(shared_inc)
    incs32 = host_inc32(inc)
    del inc
    assert np.array_equal(snp_torch.inc32_to_pairmask(inc32_shared),
                          pm.cpu().numpy().view(np.uint32))
    for k in [k for k in os.environ if k.startswith("CCPHYLO_TORCH_")]:
        del os.environ[k]  # the defaults: the card, the packed engine
    idxs = list(range(n))

    # warm-up (cuBLAS handle, allocator) outside the timed, counted run
    dist_cmd._batch_shared(s64[:256], idxs[:256], inc32_shared)
    dist_cmd._batch_pairwise(s64[:256], incs32[:256], idxs[:256])
    build.reset_launches()
    Dh, t_dist = synced(
        lambda: dist_cmd._batch_shared(s64, idxs, inc32_shared))
    (Dph, Nph), t_pair = synced(
        lambda: dist_cmd._batch_pairwise(s64, incs32, idxs))
    flat = Dh[np.tril_indices(n, -1)].astype(np.float64)

    def names():
        return [Name(b"iso%04d" % i, 32) for i in range(n)]

    # -m dnj -b at the CLI defaults: flag 0, precision 9, ByteScale 1
    nwk, t_tree = synced(lambda: tree_cmd._dispatch_build(
        flat, n, names(), "dnj", 0, 9, "b", 1.0))
    res["main_path_launches"] = dict(build.launches)
    fused_passes = int(pe.dnj_joins_packed.last_stats[0])
    pairs = n * (n - 1) / 2
    res["dist_shared_s"], res["dist_pairwise_s"] = t_dist, t_pair
    res["dist_sample_pairs_per_s"] = pairs / t_dist
    res["dist_pairwise_sample_pairs_per_s"] = pairs / t_pair
    res["tree_s"], res["tree_joins_per_s"] = t_tree, (n - 2) / t_tree
    log(f"dist seam, shared mask: {t_dist:.3f} s, {pairs / t_dist:,.0f} "
        f"sample-pairs/s; per-sample masks: {t_pair:.3f} s, "
        f"{pairs / t_pair:,.0f} sample-pairs/s")
    log(f"tree seam -m dnj -b: {t_tree:.3f} s, {(n - 2) / t_tree:,.0f} "
        f"joins/s, scan passes {fused_passes}, dnj_scan launches "
        f"{build.launches['dnj_scan']}")

    # the same path with the host-driven passes over qrow_mins: counted
    # for the `kernels` line, then timed in turns with the fused scan
    build.reset_launches()
    nwk_passes, t = synced(lambda: pe.build_tree_packed(
        flat, n, names(), scan="passes"))
    assert nwk == nwk_passes, "Newick differs from the passes run"
    assert build.launches["dnj_scan"] == 0
    res["main_path_launches"]["qrow_mins"] = build.launches["qrow_mins"]
    runs = res["tree_scan_runs"] = [
        {"scan": "fused", "s": t_tree, "passes": fused_passes,
         "kernel_launches": res["main_path_launches"]["dnj_scan"]},
        {"scan": "passes", "s": t,
         "passes": int(pe.dnj_joins_packed.last_stats[0]),
         "kernel_launches": build.launches["qrow_mins"]}]
    for name in ("passes", "fused"):
        build.reset_launches()
        out, t = synced(lambda: pe.build_tree_packed(
            flat, n, names(), scan=name))
        assert out == nwk
        runs.append({"scan": name, "s": t,
                     "passes": int(pe.dnj_joins_packed.last_stats[0]),
                     "kernel_launches": sum(build.launches.values())})
    for r in runs:
        r["joins_per_s"] = (n - 2) / r["s"]
        log(f"tree n={n} scan={r['scan']}: {r['s']:.3f} s, "
            f"{r['joins_per_s']:,.1f} joins/s, {r['passes']} passes "
            f"({r['passes'] / (n - 2):.3f} per join), "
            f"{r['kernel_launches']} scan-kernel launches "
            f"({r['kernel_launches'] / (n - 2):.3f} per join)")

    # where a join's wall time goes: the scan up to its host read, and
    # the rest (updateD, cache repair, popArrange)
    res["tree_scan_split"] = split = {}
    for name in ("fused", "passes"):
        acc = [0.0]

        def timed(*a, fn=pe.SCANS[name], acc=acc):
            t0 = time.perf_counter()
            r = fn(*a)
            r[:2].tolist()  # the engine's host read, taken here
            acc[0] += time.perf_counter() - t0
            return r

        pe.SCANS["timed"] = timed
        try:
            _, t = synced(lambda: pe.build_tree_packed(
                flat, n, names(), scan="timed"))
        finally:
            del pe.SCANS["timed"]
        split[name] = {"s": t, "scan_s": acc[0], "rest_s": t - acc[0]}
        log(f"tree n={n} scan={name}, split by host clock: {t:.3f} s, "
            f"scan with its host read {acc[0]:.3f} s "
            f"({1e3 * acc[0] / (n - 2):.3f} ms per join), rest of the "
            f"join {t - acc[0]:.3f} s "
            f"({1e3 * (t - acc[0]) / (n - 2):.3f} ms per join)")

    # dnj_scan against its plain version on every join of this run's
    # first CHECKED_JOINS, timed on the first join of each kind
    D8 = torch.from_numpy(np.clip(Dh, 0, 255).astype(np.uint8)).to(dev)
    D8 = torch.nn.functional.pad(D8, (0, pe.pad_packed(n) - n,
                                      0, pe.pad_packed(n) - n))
    checked_prefix(D8, n, CHECKED_JOINS, True, res,
                   f"scan_check_{n}")
    del D8

    # the device share of dist: snp_matrix on sequences already on the card
    D, t_dev = synced(lambda: snp_torch.snp_matrix(seqs, pm))
    res["dist_device_s"] = t_dev
    res["dist_device_sample_pairs_per_s"] = pairs / t_dev
    np.testing.assert_array_equal(D.cpu().numpy(), Dh)
    del D
    log(f"dist on the card alone (shared mask): {t_dev:.3f} s, "
        f"{pairs / t_dev:,.0f} sample-pairs/s")

    # host oracle: ops/snp.py's numpy kernels on the JAX package's layout
    check = [0, 1, n // 2, n - 1]
    np.testing.assert_array_equal(
        Dh[check], snp.cross_block(s64[check], s64, inc32_shared))
    for r in check:  # fsacmpair under the AND of both masks
        pinc = incs32 & incs32[r]
        d = snp.diff_pairs(s64, s64[r]) & snp.expand_bits(pinc)
        np.testing.assert_array_equal(
            Dph[r], np.bitwise_count(d).sum(axis=1))
        np.testing.assert_array_equal(
            Nph[r], np.bitwise_count(pinc).sum(axis=1))
    assert np.array_equal(Dh, Dh.T) and (np.diag(Dh) == 0).all()
    res["dist_median"], res["dist_max"] = (float(np.median(flat)),
                                           float(flat.max()))
    log(f"dist rows {check} equal the host kernels; median distance "
        f"{np.median(flat)}, max {flat.max()}")

    nwk_plain, t_plain = synced(lambda: pe.build_tree_packed(
        flat, n, names(), device=dev, scan="plain"))
    assert nwk == nwk_plain, "Newick differs from the plain-scan run"
    res["tree_plain_scan_s"] = t_plain
    t0 = time.perf_counter()
    # bytescale 1.0: the CLI default of -b (build_tree defaults to 128)
    nwk_host = build_tree(flat.copy(), n, names(), "dnj", dtype="b",
                          bytescale=1.0)
    res["tree_host_exact_s"] = time.perf_counter() - t0
    assert nwk == nwk_host, "Newick differs from the host exact -b engine"
    log(f"Newick ({len(nwk)} bytes) equals the plain-scan run "
        f"({t_plain:.1f} s) and the host exact -b engine "
        f"({res['tree_host_exact_s']:.1f} s)")
    return flat


# ---------------------------------------------------------------------
# phase 4: dist -> packed engine at n = 32768


def phase_scale(dev, g, res):
    n, L = N_SCALE, L_SCALE
    (seqs, shared_inc, _), t = synced(
        lambda: outbreak(dev, g, n, L, per_sample=False))
    pm = pack2(shared_inc[None].to(torch.uint8))[0]
    D, t_dist = synced(lambda: snp_torch.snp_matrix(seqs, pm))
    res["scale_dist_sample_pairs_per_s"] = n * (n - 1) / 2 / t_dist
    log(f"outbreak n={n} L={L}: generated in {t:.1f} s; dist "
        f"{t_dist:.2f} s, {n * (n - 1) / 2 / t_dist:,.0f} sample-pairs/s")
    check = [1, n - 1]
    s64 = host_u64(seqs)
    np.testing.assert_array_equal(
        D[check].cpu().numpy(),
        snp.cross_block(s64[check], s64, host_inc32(shared_inc)))
    del seqs, s64
    # loadPhy -b at ByteScale 1: integer distances, clipped to u8
    D8 = D.clamp(0, 255).to(torch.uint8)
    del D
    words = D8.clone().view(torch.int32)
    build.reset_launches()
    out, t = synced(lambda: pe.dnj_joins_packed(words, n, kbatch=KBATCH))
    launches = build.launches["dnj_scan"]
    assert launches == n - 2 and build.launches["qrow_mins"] == 0
    I, J = out[0].cpu().numpy()[:n - 2], out[1].cpu().numpy()[:n - 2]
    m_t = n - np.arange(n - 2)
    assert ((J >= 0) & (J < I) & (I < m_t)).all(), "bad join records"
    res["scale_n"], res["scale_s"] = n, t
    res["scale_joins_per_s"] = (n - 2) / t
    res["scale_scan_launches"] = launches
    res["scale_scan_passes"] = int(pe.dnj_joins_packed.last_stats[0])
    log(f"packed engine n={n}: {t:.1f} s, {(n - 2) / t:,.1f} joins/s, "
        f"{launches} dnj_scan launches, {res['scale_scan_passes']} passes "
        f"({res['scale_scan_passes'] / (n - 2):.3f} per join)")

    # dnj_scan against its plain version on the first joins of this
    # matrix, timed on the first join of each kind (no pass, one,
    # several): their mean is the `kernels` line's dnj_scan time
    s = checked_prefix(D8, n, CHECKED_JOINS, True, res,
                       f"scan_check_{n}")
    res.setdefault("kernel_ms", {})["dnj_scan"] = (s["ms"], s["plain_ms"])
    res.setdefault("bound_ms", {})["dnj_scan"] = s["bound_ms"]
    err = res.setdefault("max_abs_err", {})
    err["dnj_scan"] = max(err.get("dnj_scan", 0), s["max_abs_err"])

    # the first joins again with the plain scan, on the untouched matrix
    k = PREFIX_JOINS
    prefix = run_prefix(D8.view(torch.int32), n, k, "plain")
    for name, ours in zip(("I", "J", "DIJ2", "SDI2", "SDJ2"), out[:5]):
        np.testing.assert_array_equal(np.asarray(prefix[name])[:k],
                                      ours.cpu().numpy()[:k], err_msg=name)
    log(f"first {k} joins equal the plain-scan run")


# ---------------------------------------------------------------------
# phase 5: the float and quantized device engines of every tree method


def iso_names(n):
    return [Name(b"iso%04d" % i, 32) for i in range(n)]


def snp_flat(dev, g, n, L):
    """The integer SNP distances of an outbreak made on the card, as a
    loaded ltd matrix (float64, row-major lower triangle)."""
    seqs, shared_inc, _ = outbreak(dev, g, n, L, per_sample=False)
    pm = pack2(shared_inc[None].to(torch.uint8))[0]
    D = snp_torch.snp_matrix(seqs, pm).cpu().numpy()
    return D[np.tril_indices(n, -1)].astype(np.float64)


def random_flat(dev, g, n, lo, hi, drop=0.0):
    """A loaded ltd matrix of random integers in [lo, hi): far from
    additive and dense in ties, so (D_ik + D_kj - D_ij) / 2 gains
    fractional bits as fast as a lineage can.  `drop`: the share of
    cells that are missing (-1)."""
    cells = n * (n - 1) // 2
    flat = torch.randint(lo, hi, (cells,), device=dev, generator=g).double()
    if drop:
        gone = torch.rand(cells, device=dev, generator=g) < drop
        flat[gone] = -1.0
    return flat.cpu().numpy()


def assert_tree_shape(nwk, I, J, n):
    """n-2 joins with j < i inside the active taxa, and a Newick with n
    leaves."""
    m_t = n - np.arange(n - 2)
    assert len(I) == n - 2 and ((J >= 0) & (J < I) & (I < m_t)).all()
    assert nwk.count(b"iso") == n and nwk.count(b",") == n - 1
    assert nwk.count(b"(") == nwk.count(b")")


def dispatch(flat, n, method, dtype, engine=None, bytescale=1.0):
    """tree_cmd._dispatch_build at the CLI defaults under
    CCPHYLO_TORCH_ENGINE=engine (None: unset); returns (Newick, seconds,
    the engine that ran)."""
    os.environ.pop("CCPHYLO_TORCH_ENGINE", None)
    if engine:
        os.environ["CCPHYLO_TORCH_ENGINE"] = engine
    try:
        nwk, t = synced(lambda: tree_cmd._dispatch_build(
            flat, n, iso_names(n), method, 0, 9, dtype, bytescale))
    finally:
        os.environ.pop("CCPHYLO_TORCH_ENGINE", None)
    return nwk, t, tree_cmd._dispatch_build.last_engine


def host_tree(flat, n, method, dtype="d"):
    """The host exact engine's Newick at the CLI defaults, and its
    seconds (runs in a worker process of `phase_engines`)."""
    t0 = time.perf_counter()
    nwk = build_tree(flat.copy(), n, iso_names(n), method, dtype=dtype,
                     bytescale=1.0)
    return nwk, time.perf_counter() - t0


def fraction_bits(A: np.ndarray) -> int:
    """The most binary places after the point that a positive cell of A
    holds."""
    mant, exp = np.frexp(A[A > 0])
    mant = (mant * 2.0 ** 53).astype(np.int64)
    zeros = np.log2((mant & -mant).astype(np.float64)).astype(np.int64)
    return int((53 - zeros - exp).max(initial=0))


def exact_range(flat, n, dev, every=64):
    """The float64 DNJ engine on the card, stopped every `every` joins
    to read how far its state is from the end of float64's exact range:
    the fractional bits of the cells, the bits a row sum needs (integer
    bits of the largest sum plus those fractional bits), and whether
    every sD equals the sum of its row taken in 64-bit-mantissa long
    doubles on the host (it does while the sums are exact).  Complete
    matrices only.  Returns (I, J, statistics)."""
    D = torch.from_numpy(te.square_matrix(flat, n)).to(dev)
    st = te._new_state(D, n)
    out = {"fraction_bits": 0, "sum_bits": 0, "inexact_sums": 0,
           "states_read": 0}
    for t0 in range(0, n - 2, every):
        m_t = n - t0
        A = st["D"][:m_t, :m_t].cpu().numpy()
        sD = st["sD"][:m_t].cpu().numpy()
        wide = np.where(A >= 0, A, 0).astype(np.longdouble).sum(axis=1)
        bits = fraction_bits(A)
        out["fraction_bits"] = max(out["fraction_bits"], bits)
        out["sum_bits"] = max(out["sum_bits"],
                              bits + int(np.ceil(np.log2(sD.max() + 1))))
        out["inexact_sums"] += int((wide != sD.astype(np.longdouble)).sum())
        out["states_read"] += 1
        te._dnj_segment(st, t0, min(t0 + every, n - 2), n)
    return st["I"][:n - 2].copy(), st["J"][:n - 2].copy(), out


def phase_engines(dev, g, res, flat=None):
    for k in [k for k in os.environ if k.startswith("CCPHYLO_TORCH_")]:
        del os.environ[k]  # the defaults: the card
    if flat is None:  # run alone: the main path's model, its own seed
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 1)
        flat = snp_flat(dev, g, N_DIST, L_DIST)
    # the host exact engine runs in worker processes
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(4, mp_context=ctx) as pool:
        engines_on_card(dev, g, res, flat, pool)


def engines_on_card(dev, g, res, flat, pool):
    n = N_DIST
    assert np.array_equal(flat, np.floor(flat)) and flat.min() >= 0
    out = res["engines"] = {}
    joins = n - 2
    runs = {}  # key -> (flat, method, dtype, Newick, seconds, engine)

    # the matrix of the run at depth, first: its host run takes minutes,
    # so one worker starts on it now and works beside the card's runs
    # (one busy core of the host's); all other host runs wait for them
    nd = N_DEPTH
    dflat = snp_flat(dev, g, nd, L_SCALE)
    f_depth = pool.submit(host_tree, dflat, nd, "dnj")

    # every method on the default route; then dnj on u16 cells (-s, the
    # default route) and on u8 cells (device64 -b)
    te.dnj_joins(torch.zeros((64, 64), dtype=torch.float64, device=dev),
                 64)  # warm-up outside the timed runs
    for method in TREE_METHODS:
        want = "float64" if method == "dnj" else "hclust/float64"
        nwk, t, ran = dispatch(flat, n, method, "d")
        assert ran == want, (method, ran)
        runs[method] = (flat, method, "d", nwk, t, ran)
    for dtype, engine, want in (("s", None, "u16/float64"),
                                ("b", "device64", "u8/float64")):
        nwk, t, ran = dispatch(flat, n, "dnj", dtype, engine)
        assert ran == want, ran
        runs["dnj -" + dtype] = (flat, "dnj", dtype, nwk, t, ran)

    # the default route on a matrix that is not additive: random
    # integers in [0, 25), the methods whose host run takes seconds
    rflat = random_flat(dev, g, n, 0, 25)
    for method in RANDOM_METHODS:
        want = "float64" if method == "dnj" else "hclust/float64"
        nwk, t, ran = dispatch(rflat, n, method, "d")
        assert ran == want, (method, ran)
        runs[method + ", random cells"] = (rflat, method, "d", nwk, t, ran)

    # dnj on float32 state: shape only; agreement with float64 printed
    nwk32, t32, ran32 = dispatch(flat, n, "dnj", "d", "device")
    assert ran32 == "float32", ran32

    # a non-integer copy: the default route is the host, with its note;
    # device64 -m upgma runs on the card
    noise = torch.rand(flat.shape[0], dtype=torch.float64, device=dev,
                       generator=g).cpu().numpy()
    fflat = flat + 0.5 * noise
    note = io.StringIO()
    with contextlib.redirect_stderr(note):
        nwk_host, t_host, ran = dispatch(fflat, n, "upgma", "d")
    assert ran == "exact", ran
    assert note.getvalue().count("\n") == 1 \
        and "CCPHYLO_TORCH_ENGINE=device64" in note.getvalue()
    nwk, t, ran = dispatch(fflat, n, "upgma", "d", "device64")
    assert ran == "hclust/float64", ran
    assert nwk.count(b"iso") == n and nwk.count(b",") == n - 1
    out["upgma_non_integer"] = {
        "engine": ran, "s": t, "joins_per_s": joins / t,
        "host_exact_s": t_host, "equals_host": nwk == nwk_host}
    log(f"non-integer matrix, -m upgma: default route [exact] {t_host:.1f} "
        f"s with its note; device64 [{ran}] {t:.3f} s, {joins / t:,.1f} "
        f"joins/s, Newick equals the host engine's: {nwk == nwk_host}")

    # at depth: dnj, float64, batch scan, n = N_DEPTH
    D = torch.from_numpy(te.square_matrix(dflat, nd)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    (I, J, LI, LJ, d_last, _), t_depth = synced(lambda: te.dnj_joins(D, nd))
    del D
    nwk_depth = te._records_to_newick(I, J, LI, LJ, d_last, nd,
                                      iso_names(nd), 0, 9)
    assert_tree_shape(nwk_depth, I[:nd - 2], J[:nd - 2], nd)
    assert np.isfinite(LI[:nd - 2]).all() and np.isfinite(LJ[:nd - 2]).all()
    peak = torch.cuda.max_memory_allocated()

    # the host exact engine on the same matrices, now that the card's
    # runs are timed (nj and mn take it about a minute each); every
    # Newick of a default route must equal its host twin's bytes
    futures = {key: pool.submit(host_tree, fl, n, method, dtype)
               for key, (fl, method, dtype, *_) in runs.items()}
    mflat = random_flat(dev, g, n, 0, 25, drop=0.12)
    f_miss = {m: pool.submit(host_tree, mflat, n, m)
              for m in MISSING_METHODS}

    # beside the workers, the card's runs whose time is not kept.
    # Missing cells (12% of a random matrix): the default route is the
    # host's, with its note; device64 runs on the card, and whether its
    # bytes are the host's is printed, not asserted (no sum is exact)
    note = io.StringIO()
    with contextlib.redirect_stderr(note):
        _, _, ran = dispatch(mflat, n, "cf", "d")
    assert ran == "exact" and note.getvalue().count("\n") == 1 \
        and "missing cells" in note.getvalue(), (ran, note.getvalue())
    missing = {}
    for method in MISSING_METHODS:
        nwk, _, ran = dispatch(mflat, n, method, "d", "device64")
        assert ran == ("float64" if method == "dnj" else "hclust/float64")
        assert nwk.count(b"iso") == n
        missing[method] = (nwk, ran)

    # the float32 run's records, and how much of float64's exact range
    # the float64 runs above used
    D32 = torch.from_numpy(te.square_matrix(flat, n)).to(dev, torch.float32)
    I32, J32 = (a[:joins] for a in te.dnj_joins(D32, n)[:2])
    assert_tree_shape(nwk32, I32, J32, n)
    I64, J64, out["exact_range_snp"] = exact_range(flat, n, dev)
    _, _, out["exact_range_random"] = exact_range(rflat, n, dev)
    for key in ("exact_range_snp", "exact_range_random"):
        s = out[key]
        assert s["inexact_sums"] == 0 and s["sum_bits"] <= 53, (key, s)
        log(f"{key} n={n} dnj float64: cells hold at most "
            f"{s['fraction_bits']} fractional bits, a row sum needs at "
            f"most {s['sum_bits']} of 53 bits; every sD equals its row's "
            f"long-double sum in the {s['states_read']} states read")
    same = (I32 == I64) & (J32 == J64)
    first = int(np.argmin(same)) if not same.all() else joins
    out["dnj_float32"] = {"engine": ran32, "s": t32,
                          "joins_per_s": joins / t32,
                          "joins_equal_float64": int(same.sum()),
                          "first_differing_join": first}
    log(f"tree n={n} -m dnj [{ran32}]: {t32:.3f} s, {joins / t32:,.1f} "
        f"joins/s; {int(same.sum())} of {joins} joins pick the float64 "
        f"run's pair, the first {first} in a row")

    hosts = {key: f.result() for key, f in futures.items()}
    host_miss = {m: f.result() for m, f in f_miss.items()}
    host_depth, t_host_depth = f_depth.result()
    for key, (_, method, dtype, nwk, t, ran) in runs.items():
        host, t_host = hosts[key]
        assert nwk == host, f"-m {key}: Newick differs from the host " \
                            "exact engine"
        out[key] = {"engine": ran, "s": t, "joins_per_s": joins / t,
                    "host_exact_s": t_host}
        log(f"tree n={n} -m {key} [{ran}]: {t:.3f} s, {joins / t:,.1f} "
            f"joins/s; Newick ({len(nwk)} bytes) equals the host exact "
            f"engine ({t_host:.1f} s in a worker process)")
    for method, (nwk, ran) in missing.items():
        host, t_host = host_miss[method]
        out[method + ", 12% missing"] = {
            "engine": ran, "host_exact_s": t_host,
            "equals_host": nwk == host}
        log(f"12% missing cells, device64 -m {method} [{ran}]: Newick "
            f"equals the host engine's: {nwk == host} (host {t_host:.1f} "
            f"s); the default route is the host's")
    assert nwk_depth == host_depth, \
        f"dnj at n={nd}: Newick differs from the host exact engine"
    out["dnj_depth"] = {"n": nd, "s": t_depth,
                        "joins_per_s": (nd - 2) / t_depth,
                        "peak_bytes": peak, "host_exact_s": t_host_depth}
    log(f"tree n={nd} dnj float64 batch: {t_depth:.1f} s, "
        f"{(nd - 2) / t_depth:,.1f} joins/s, peak device memory "
        f"{peak / 2 ** 20:.0f} MiB; Newick ({len(nwk_depth)} bytes) equals "
        f"the host exact engine ({t_host_depth:.1f} s in a worker process)")


def phase_profile(dev, res):
    """Kernel launches, host reads (device-to-host copies) and device
    time per join of each device engine at n = 2048: joins 64..128 are
    timed on the host's clock, joins 128..192 run in a torch.profiler
    window; the idle share is device time over the un-profiled wall."""
    from torch.profiler import ProfilerActivity, profile
    n, k = N_DIST, PROFILE_JOINS
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    D0 = torch.from_numpy(te.square_matrix(snp_flat(dev, g, n, L_DIST), n))
    out = res["profile"] = {}
    for method in TREE_METHODS:
        if method == "dnj":
            st, seg = te._new_state(D0.to(dev), n), te._dnj_segment
        else:
            st, seg = he._new_state(D0.to(dev), n, method)
            seg = functools.partial(seg, method=method)

        def run(t0, t1):
            seg(st, t0, t1, n)
            torch.cuda.synchronize()

        run(0, k)
        _, plain_wall = synced(lambda: run(k, 2 * k))
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(2 * k, 3 * k)
        wall = time.perf_counter() - t0
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in dev_events if "Memcpy" not in e.name
                   and "Memset" not in e.name]
        reads = [e for e in dev_events if "Memcpy DtoH" in e.name]
        busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
        assert kernels and reads, "the profiler saw no device activity"
        idle = 1 - busy_us / 1e6 / plain_wall
        out[method] = {"launches_per_join": len(kernels) / k,
                       "host_reads_per_join": len(reads) / k,
                       "device_ms_per_join": busy_us / 1e3 / k,
                       "wall_ms_per_join": plain_wall * 1e3 / k,
                       "wall_ms_per_join_profiled": wall * 1e3 / k,
                       "device_idle_share": idle}
        log(f"profile -m {method} at n={n}: joins {2 * k}..{3 * k} under "
            f"the profiler: {len(kernels) / k:.1f} kernel launches, "
            f"{len(reads) / k:.2f} host reads, {busy_us / 1e3 / k:.3f} ms "
            f"of device time per join ({wall * 1e3 / k:.3f} ms wall); "
            f"joins {k}..{2 * k} without it: {plain_wall * 1e3 / k:.3f} ms "
            f"wall per join, {plain_wall * 1e6 / k / (len(kernels) / k):.1f}"
            f" us per launch, device idle {idle:.1%}")


# ---------------------------------------------------------------------
# phase 6: the CLI on the card against the CLI on the host code


def phase_cli(res):
    sys.path.insert(0, REPO)
    from tests.gen_kma_data import make_dataset

    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("CCPHYLO_TPU_", "CCPHYLO_TORCH_", "JAX_"))}
    base["PYTHONPATH"] = REPO
    # no CCPHYLO_TORCH_* variable: the card and the packed engine
    host_env = dict(base, CCPHYLO_TORCH_DIST="host",
                    CCPHYLO_TORCH_ENGINE="exact")

    def run(args, env, cwd):
        p = subprocess.run([sys.executable, "-m", "ccphylo_tpu_torch"]
                           + args, env=env, cwd=cwd, capture_output=True,
                           timeout=300)
        assert p.returncode == 0, p.stderr.decode(errors="replace")
        return p.stdout

    with tempfile.TemporaryDirectory() as d:
        make_dataset(Path(d), n_samples=24, length=3000)
        fsas = sorted(f for f in os.listdir(d) if f.endswith(".fsa.gz"))
        for flags in (["-f", "17"], ["-f", "19"]):
            args = ["dist", "-r", "tpl1"] + flags + ["-i"] + fsas
            ours = run(args, base, d)
            assert ours == run(args, host_env, d), flags
            assert ours.count(b"\n") == 25
        phy = os.path.join(d, "d.phy")
        with open(phy, "wb") as fh:
            fh.write(ours)
        targs = ["tree", "-m", "dnj", "-b", "-i", phy]
        nwk = run(targs, base, d)
        assert nwk == run(targs, host_env, d)
        assert nwk.endswith(b";\n")
        # the float64 device engines: an integer matrix, no variable set
        for method in ("nj", "dnj"):
            targs = ["tree", "-m", method, "-i", phy]
            nwk = run(targs, base, d)
            assert nwk == run(targs, host_env, d), method
            assert nwk.endswith(b";\n")
    log("CLI dist -f 17 / -f 19, tree -m dnj -b, tree -m nj and tree -m "
        "dnj on the card equal the host code's bytes")


PHASES = ("kernels", "main_path", "scale", "engines", "cli", "profile")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    res = {}
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    only = sys.argv[1:]
    if not set(only) <= set(PHASES):
        print(f"chip_smoke: phases are {PHASES}", file=sys.stderr)
        return 2
    res["build_s"] = build.build_all()
    log(f"built kernels in {res['build_s']:.1f} s")
    shared = {}  # the main path's SNP matrix, for the engines phase
    for name, phase in zip(PHASES, (
            lambda: phase_kernels(dev, g, res),
            lambda: shared.update(flat=phase_main_path(dev, g, res)),
            lambda: phase_scale(dev, g, res),
            lambda: phase_engines(dev, g, res, shared.get("flat")),
            lambda: phase_cli(res), lambda: phase_profile(dev, res))):
        if name in only or (not only and name != "profile"):
            phase()
    res["total_s"] = time.perf_counter() - t_start

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    print(json.dumps({"results": res}))
    print(card)
    if only:
        return 0
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        ms, plain = res["kernel_ms"][name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": res["main_path_launches"][name],
                        "max_abs_err": res["max_abs_err"][name],
                        "ms": ms, "plain_ms": plain,
                        "bound_ms": res["bound_ms"][name],
                        "bound_by": "bytes", "library_ms": None})
    assert all(k["launches"] > 0 for k in kernels), kernels
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
