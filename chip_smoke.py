"""On-chip smoke run of the PyTorch/CUDA port (ccphylo_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py        # from the root of a checkout, one card

It imports no JAX.  Its oracles are the port's plain PyTorch versions of
each kernel and the JAX package's host-only numpy code
(ccphylo_tpu.ops.snp, ccphylo_tpu.tree.exact, the host CLI).  Phases, in
order; any failure raises and exits non-zero, no exception is caught:

1. build: compile the CUDA kernels from ccphylo_tpu_torch/csrc (nvcc,
   sm_90a, one process per source, in parallel);
2. kernels: hold each kernel bit-exactly against its plain version on
   the card, at the main path's shapes, and time both;
3. main path: n = 2048 isolates of L = 1 Mbp, a clonal outbreak
   generated on the card from a seed, through the port's CLI seams on
   the host arrays the CLI hands them: `dist` (dist_cmd._batch_shared
   and _batch_pairwise; rows checked against the host numpy kernels)
   into `tree -m dnj -b` (tree_cmd._dispatch_build on the packed
   engine; Newick checked against the plain-scan run and the host exact
   -b engine).  The launch counts of the `kernels` line are this
   phase's;
4. at scale: n = 32768 isolates of 100 kbp from the same outbreak
   model, through `dist` into the packed engine (a 1 GiB u8 matrix);
   dist rows are checked against the host kernels and the first joins
   against a plain-scan run;
5. CLI: python -m ccphylo_tpu_torch dist and tree -m dnj -b on
   make_dataset files, byte-equal to the host python -m ccphylo_tpu.

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

from ccphylo_tpu.io.qseqs import Name
from ccphylo_tpu.ops import snp
from ccphylo_tpu.tree.exact import build_tree
from ccphylo_tpu_torch.cli import dist_cmd, tree_cmd
from ccphylo_tpu_torch.ops import build, scan, snp_torch
from ccphylo_tpu_torch.tree import packed_engine as pe
from ccphylo_tpu_torch.tree import segmenting

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
N_DIST, L_DIST = 2048, 1_000_000
N_SCALE, L_SCALE = 32768, 100_000
EXP_ROWS, EXP_WORDS = 2048, 2048  # one genome chunk of the main path
PREFIX_JOINS = 1024  # plain-scan check of the phase-4 run
KERNEL_META = {
    "snp_expand_shared": ("ccphylo_tpu_torch/csrc/snp_expand.cu",
                          "ccphylo_tpu/ops/snp_pallas.py:69"),
    "snp_expand_pairwise": ("ccphylo_tpu_torch/csrc/snp_expand.cu",
                            "ccphylo_tpu/ops/snp_pallas.py:80"),
    "qrow_mins": ("ccphylo_tpu_torch/csrc/qrow_mins.cu",
                  "ccphylo_tpu/ops/scan_pallas.py:49"),
}


def log(*a):
    print("#", *a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` launches (warm)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
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


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions


def phase_kernels(dev, g, res):
    err = {k: 0 for k in KERNEL_META}

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
    words.fill_(0x05050505)  # every cell 5: every column ties
    sd2.zero_()
    rmin, rarg = scan.qrow_mins(rows, 10, words, sd2)
    assert torch.equal(rarg, rows - 1) and bool((rmin == 50).all())
    err["qrow_mins"] = max(err["qrow_mins"], max_abs_err(
        (rmin, rarg), scan.qrow_mins_plain(rows, 10, words, sd2)))
    res["max_abs_err"] = err
    assert all(v == 0 for v in err.values()), err
    for k, (ms, plain) in t.items():
        log(f"kernel {k}: {ms:.4f} ms, plain version {plain:.4f} ms, "
            f"max_abs_err {err[k]}")


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
    os.environ.pop("CCPHYLO_TPU_CKPT", None)
    os.environ["CCPHYLO_TORCH_DIST"] = "device"
    os.environ["CCPHYLO_TORCH_ENGINE"] = "packed"
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
    pairs = n * (n - 1) / 2
    res["dist_shared_s"], res["dist_pairwise_s"] = t_dist, t_pair
    res["dist_sample_pairs_per_s"] = pairs / t_dist
    res["dist_pairwise_sample_pairs_per_s"] = pairs / t_pair
    res["tree_s"], res["tree_joins_per_s"] = t_tree, (n - 2) / t_tree
    log(f"dist seam, shared mask: {t_dist:.3f} s, {pairs / t_dist:,.0f} "
        f"sample-pairs/s; per-sample masks: {t_pair:.3f} s, "
        f"{pairs / t_pair:,.0f} sample-pairs/s")
    log(f"tree seam -m dnj -b: {t_tree:.3f} s, {(n - 2) / t_tree:,.0f} "
        f"joins/s, scan passes {int(pe.dnj_joins_packed.last_stats[0])}")

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
        flat, n, names(), device=dev, qrow=scan.qrow_mins_plain))
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


class _Stop(Exception):
    pass


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
    out, t = synced(lambda: pe.dnj_joins_packed(words, n))
    launches = build.launches["qrow_mins"]
    assert launches > 0
    I, J = out[0].cpu().numpy()[:n - 2], out[1].cpu().numpy()[:n - 2]
    m_t = n - np.arange(n - 2)
    assert ((J >= 0) & (J < I) & (I < m_t)).all(), "bad join records"
    res["scale_n"], res["scale_s"] = n, t
    res["scale_joins_per_s"] = (n - 2) / t
    res["scale_scan_launches"] = launches
    res["scale_scan_passes"] = int(pe.dnj_joins_packed.last_stats[0])
    log(f"packed engine n={n}: {t:.1f} s, {(n - 2) / t:,.0f} joins/s, "
        f"{launches} scan launches, {res['scale_scan_passes']} passes")

    # the first joins again with the plain scan, on the untouched matrix
    prefix = {}

    def stop(st, done, total):
        prefix.update({k: np.array(st[k]) for k in ("I", "J")})
        prefix.update({k: st[k].cpu().numpy() for k in
                       ("DIJ2", "SDI2", "SDJ2")})
        raise _Stop

    seg, segmenting.SEG = segmenting.SEG, PREFIX_JOINS
    try:
        pe.dnj_joins_packed(D8.view(torch.int32), n, hooks=stop,
                            qrow=scan.qrow_mins_plain)
    except _Stop:
        pass
    finally:
        segmenting.SEG = seg
    k = PREFIX_JOINS
    for name, ours in zip(("I", "J", "DIJ2", "SDI2", "SDJ2"), out[:5]):
        np.testing.assert_array_equal(np.asarray(prefix[name])[:k],
                                      ours.cpu().numpy()[:k], err_msg=name)
    log(f"first {k} joins equal the plain-scan run")


# ---------------------------------------------------------------------
# phase 5: the CLI against the host reference


def phase_cli(res):
    sys.path.insert(0, REPO)
    from tests.gen_kma_data import make_dataset

    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("CCPHYLO_TPU_", "CCPHYLO_TORCH_", "JAX_"))}
    base["PYTHONPATH"] = REPO
    port_env = dict(base, CCPHYLO_TORCH_DIST="device",
                    CCPHYLO_TORCH_ENGINE="packed")

    def run(pkg, args, env, cwd):
        p = subprocess.run([sys.executable, "-m", pkg] + args, env=env,
                           cwd=cwd, capture_output=True, timeout=300)
        assert p.returncode == 0, p.stderr.decode(errors="replace")
        return p.stdout

    with tempfile.TemporaryDirectory() as d:
        make_dataset(Path(d), n_samples=24, length=3000)
        fsas = sorted(f for f in os.listdir(d) if f.endswith(".fsa.gz"))
        for flags in (["-f", "17"], ["-f", "19"]):
            args = ["dist", "-r", "tpl1"] + flags + ["-i"] + fsas
            ours = run("ccphylo_tpu_torch", args, port_env, d)
            assert ours == run("ccphylo_tpu", args, base, d), flags
            assert ours.count(b"\n") == 25
        phy = os.path.join(d, "d.phy")
        with open(phy, "wb") as fh:
            fh.write(ours)
        targs = ["tree", "-m", "dnj", "-b", "-i", phy]
        nwk = run("ccphylo_tpu_torch", targs, port_env, d)
        assert nwk == run("ccphylo_tpu", targs, base, d)
        assert nwk.endswith(b";\n")
    log("CLI dist -f 17 / -f 19 and tree -m dnj -b equal the host bytes")


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

    res["build_s"] = build.build_all()
    log(f"built kernels in {res['build_s']:.1f} s")
    phase_kernels(dev, g, res)
    phase_main_path(dev, g, res)
    phase_scale(dev, g, res)
    phase_cli(res)
    res["total_s"] = time.perf_counter() - t_start

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    print(json.dumps({"results": res}))
    print(card)
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        ms, plain = res["kernel_ms"][name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": res["main_path_launches"][name],
                        "max_abs_err": res["max_abs_err"][name],
                        "ms": ms, "plain_ms": plain})
    assert all(k["launches"] > 0 for k in kernels), kernels
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
