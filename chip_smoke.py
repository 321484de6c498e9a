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
5. CLI: python -m ccphylo_tpu_torch dist and tree -m dnj -b on
   make_dataset files, on the card by default, byte-equal to the same
   commands on the host code.

`python3 chip_smoke.py kernels main_path` runs the build and only the
named phases (kernels, main_path, scale, cli) and prints their results
without the contract lines: for work on one phase.

The last two lines are the `kernels` JSON and the contract line
{"ok": true, "device": {...}}; before them, the card's name and power
limit as nvidia-smi reports them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ccphylo_tpu_torch.cli import dist_cmd, tree_cmd
from ccphylo_tpu_torch.io.qseqs import Name
from ccphylo_tpu_torch.ops import build, scan, snp, snp_torch
from ccphylo_tpu_torch.tree.exact import build_tree
from ccphylo_tpu_torch.tree import packed_engine as pe
from ccphylo_tpu_torch.tree import segmenting

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
N_DIST, L_DIST = 2048, 1_000_000
N_SCALE, L_SCALE = 32768, 100_000
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
# phase 5: the CLI on the card against the CLI on the host code


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
    log("CLI dist -f 17 / -f 19 and tree -m dnj -b on the card equal the "
        "host code's bytes")


PHASES = ("kernels", "main_path", "scale", "cli")


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
    for name, phase in zip(PHASES, (
            lambda: phase_kernels(dev, g, res),
            lambda: phase_main_path(dev, g, res),
            lambda: phase_scale(dev, g, res), lambda: phase_cli(res))):
        if not only or name in only:
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
