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
   the card, at the main path's shapes, and time both (the pairwise
   expansion also on the loader's include words against their pair
   masks, the two mask layouts timed in turns).  The segment kernel
   `dnj_segment`, each of its flag sets (SEG_FLAGS: Q in shared memory,
   the default, or read through L2), is held against
   `dnj_segment_plain` at every boundary of CHECK_SEG joins
   (`held_to_plain`), every state array, the flag sets timed in turns,
   here on an all-tie matrix and in phases 3 and 4 on a real run;
3. main path: n = 2048 isolates of L = 1 Mbp, a clonal outbreak
   generated on the card from a seed, through the port's CLI seams on
   the host arrays the CLI hands them: `dist` (dist_cmd._batch_shared
   and _batch_pairwise; rows checked against the host numpy kernels)
   into `tree -m dnj -b` (tree_cmd._dispatch_build on the packed
   engine's device loop: one dnj_segment launch per segment of
   segmenting.SEG joins, no other launch, no host read between fences;
   its seconds split into quantization, engine, limbs and Newick;
   Newick checked against the host exact -b engine).  The launch counts
   of the `kernels` line are this phase's: the counters are set to 0
   just before the path and read just after it, and each kernel's entry
   names its path (KERNEL_PATH): dnj_segment and the expansion kernels
   the main path (dist and the seam's tree), qrow_mins_slots the
   streamed phase, dnj_segment_float the engines phase; qrow_mins
   without slots, which no path launches, is held and timed in phase 2
   and has no entry there.  dnj_segment is held
   to its plain version at every CHECK_SEG joins of the whole tree;
   `probe_segment` runs the first segment under
   torch.cuda.set_sync_debug_mode("error") (a host read would raise)
   and measures the card's ms per join (CUDA events, the launch queued
   behind a spin) and the host's µs per segment; `segment_breakdown`
   splits a segment's card time into the parts of a join (the kernel's
   PROFILE clock counts);
4. at scale: n = 32768 isolates of 100 kbp from the same outbreak
   model, through `dist` into the packed engine (a 1 GiB u8 matrix);
   dist rows are checked against the host kernels, the first
   PREFIX_JOINS joins against the plain loop, dnj_segment at every
   CHECK_SEG joins of the first CHECKED_JOINS (its first launch the
   `kernels` line's), `probe_segment` and `segment_breakdown` as in
   phase 3.  Then the
   float engine's segment kernel `dnj_segment_float` on the float64
   copy of this matrix (8.6 GB): held to `dnj_segment_float_plain` at
   every boundary of CHECK_SEG joins of the first CHECKED_JOINS, every
   state array equal (`held_float`), in its default design at this
   size, the candidate list (its first launch the `kernels` line's,
   timed by CUDA events, with the plain loop and the byte bound; the
   list overflows there, so its top-ups are held too, asserted), and in
   the first design (ROWS); the two designs timed in turns, list, rows,
   rows, list, and each one's time by part of a join
   (`float_breakdown`, the PROFILE clock counts of every block); the
   float32 instance held the same way in both designs on the float32
   copy, the exact range tracked (bit-equal until both stop at the same join),
   then untracked beside the plain loop (`float_agreement`: the first
   join whose pick differs, printed); and the whole tree in float64
   (`float_tree_at_scale`: tracked on the card, the join where it
   leaves the exact range; then untracked through build_tree_float:
   joins/s, launches, the seconds of the host's part, the engine's init
   and its joins, the peak memory, the tree's shape);
4b. parity (after phase 4): the packed engine's whole tree on the
   synthetic hash matrix of benchmarks/synth.py (mod 97, lo 3), made on
   the card (`hash_words`; 4096 cells checked against a numpy copy of
   the hash), at n = 20,000 (20,480 rows, Q in shared memory) and
   n = 100,000 (100,352 rows, 10.07 GB; Q read through L2), through
   dnj_joins_packed, limbs_host and _records_to_newick on names with
   the Phylip loader's capacities: each Newick's sha256 equals the C
   reference's (benchmarks/evidence/README.md), at 100,000 the bytes
   equal the gunzipped parity100k.c.nwck.gz and the records digest
   the evidence's; the run's flags and launches asserted (one
   dnj_segment a segment, nothing else).  At 100,000 first dnj_segment
   without Q against dnj_segment_plain every CHECK_SEG joins of the
   first CHECKED_JOINS, `probe_segment` and `segment_breakdown`; the
   seconds of each step, joins/s, passes per join and the peak memory
   on the card printed with the card's name and power limit;
5. engines: the float64 device engines of all seven tree methods
   (tree/torch_engine.py, tree/hclust_engine.py) on phase 3's integer
   SNP matrix as a double-precision matrix, through
   tree_cmd._dispatch_build with no variable set: each Newick
   byte-equal to the host exact engine's, the engine that ran
   asserted, joins/s printed; dnj on float64 and float32 state runs
   one dnj_segment_float launch a segment (the first design, ROWS, by
   default at this size; the candidate-list design held to the plain
   loop on the first CHECKED_JOINS joins, complete, where its list
   overflows (asserted), and with missing cells, and timed in turns
   against it by `float_breakdown`).  dnj through the default route
   again with the kernel and with the plain loop in turns
   (`float_turns`: joins/s, launches and waits for the card per join,
   and 64 joins of each loop under torch.profiler; the first run's
   launches are the `kernels` line's).  Then dnj on u16 cells (-s) and on u8
   cells (`device64` -b), both byte-equal to the host engine; dnj,
   upgma, cf and hnj on a matrix of random integers in [0, 25), far
   from additive and dense in ties (the hclust engines on its first
   N_RANDOM taxa), byte-equal too (the default route
   tracks float64's exact range: a run whose row sums leave it is
   handed to the host engine with a note, and is then timed under
   `device64`, its bytes printed, not asserted); the same with 12%
   of the cells missing (the default route goes to the host with its
   note; `device64` runs on the card, equality printed; the kernel's
   instance with missing cells held to the plain loop over the first
   SEG joins, picks equal and limbs within 1e-12 of max(|x|, 1)); dnj on
   float32 state (`device`; shape only, agreement with the float64
   run printed; the kernel's float32 instance held to the plain loop
   with the exact range tracked, bit-equal until both stop); how many
   of float64's 53 bits the cells and row sums
   of the SNP and the random run used (`exact_range`: every sum must
   be exact); on a caterpillar-like matrix of N_CATERPILLAR taxa, the
   bits dnj and upgma reach and the default route (dnj leaves the exact
   range and goes to the host with its note, before the join at which
   the plain loop with the exact range tracked stops); a non-integer
   copy of the SNP matrix's first N_RANDOM taxa (the default route goes
   to the host with its note, `device64` -m upgma runs on the card);
   and dnj in float64 at n = N_DEPTH from phase 4's outbreak model,
   timed, byte-equal to the host exact engine (the depth is cut
   to leave the script's time limit to the other phases: the host
   engine needs 4-5 minutes at n = 8192; the sharded phase runs this
   engine at n = N_SHARDED).  The host engine's runs are
   made in worker processes after the card's timed runs, but for the
   three that take a minute or more (the one at depth, nj and mn),
   which run in workers beside them;
6. streamed (run right after phase 4, on its matrix): the row-cache
   engine (tree/streamed_engine.py) on the n = 32768 u8 matrix held on
   the host (1 GiB) with a cache of X = 8192 rows on the card: the first
   STREAM_JOINS joins, records equal to the packed engine's on the same
   matrix,
   joins/s of both, misses, rows and bytes uploaded, and the shares of
   the run spent in uploads, in the host replay and in driving the
   card.  The launch count of `qrow_mins_slots` in the
   `kernels` line is this run's.  Then a whole run at n = N_STREAM,
   X = X_STREAM: every record and the final matrix equal the packed
   engine's;
7. matdist: k = 128 count matrices of L = 1 Mbp made on the card from a
   seed (uint16, depth ~40, a tenth of the positions shallow, three
   samples shorter): -d cos through ops/matdist_torch.pair_table in
   float64 and float32, every other metric at L = 100 kbp in float64;
   against the host's cmp_mats on 32 sampled pairs: rows_inc equal for
   all, sums bit-equal for l1 and linf, the largest relative error
   printed for the rest; pair-positions/s and the shares of the time
   spent packing chunks and in the copy calls; whether z's gate on
   the card equals the host's on every column up to depth 4096 and on
   the columns around each alpha's crossing up to depth 65535;
8. sharded (run after phase 5, on the main path's matrix): the engines
   of parallel/ at world size 1 through a real NCCL group on the card:
   sharded_snp_matrix at n = 2048, L = 1 Mbp against snp_matrix (its
   snp_expand_shared launches counted), sharded DNJ in float64 at
   n = N_SHARDED against the float64 engine (records bit-equal, joins/s,
   passes, host reads and collectives per join), nj and upgma at
   n = 2048 against the same function on CPU tensors in worker
   processes (gloo);
9. CLI: python -m ccphylo_tpu_torch dist, tree -m dnj -b, tree -m nj
   and tree -m dnj on make_dataset files, on the card by default,
   byte-equal to the same commands on the host code, and tree -m dnj
   under CCPHYLO_TORCH_ENGINE=sharded against its run on CPU tensors;
   dist on the
   .mat.gz files: -d l1, z (the card) byte-equal to the host metrics,
   -d cos (the host, with its stderr line) and -d cos under
   CCPHYLO_TORCH_DIST=device (the card, cells within 1e-9).  Then the
   twelve host subcommands, side by side, each exiting 0: phycmp of the
   card's dist matrix against the host route's, fullphy and dbscan of
   both matrices and nwck2phy of both tree -m dnj -b Newicks byte-equal
   to each other, merge, tsv2phy, tsv2nwck, makespan, union, rarify,
   trim and seq2fasta on small seeded inputs; and dist -f 17 and
   tree -m dnj -b (on the untraced dist's matrix) under
   CCPHYLO_TORCH_PROFILE=<dir>, side by side with the same tree
   untraced: each writes a torch.profiler Chrome trace whose `kernel`
   events name the kernels it runs (expand_shared_kernel;
   dnj_segment_kernel);
10. dryrun: ccphylo_tpu_torch/dryrun.py, the compile check and
   dry run: entry()'s SNP matrix on the card against CPU tensors; with
   one card, dryrun_multichip(2) refused before any process starts;
   dryrun_multichip(1) on the card (NCCL), the same on CPU tensors
   (gloo) and `python -m ccphylo_tpu_torch.dryrun`, side by side:
   every stage's records equal, the rank's launches of
   snp_expand_shared, dnj_segment, qrow_mins through slots and
   dnj_segment_float above 0, each stage's seconds printed.

`python3 chip_smoke.py kernels main_path` runs the build and only the
named phases (kernels, main_path, scale, parity, streamed, engines,
sharded, matdist, cli, dryrun, profile, float_sizes, dist_ring) and
prints their results without the contract lines: for work on one
phase.  `float_sizes` runs only when named (`phase_float_sizes`):
dnj_segment_float's designs in turns where the default switches
between them (ROWS and the list at n = 2048 to 4096; the list from the
copy of Q and from slices at 8192 to 24576), a whole float64 run at n
= 32768 in each of ROWS and the list, segment by segment, and builds
of the kernel with other constants (the list's capacity, a piece's
units) in turns with the source's.  `dist_ring` runs only when named
(`phase_dist_ring`): a dist fill's rows staged on the card at
mrsa-2282's size, in turns: the host stack with its pageable upload
and pad copy, a pageable copy a row, and `padded_rows`' pinned ring in
variants.  `profile` runs only when named,
and on its own: after the
`engines` phase in one process its torch.profiler windows see no
device activity on the card (the engines phase's own window, taken
alone before it, does not cause this).  It times 64 joins of each
device engine (dnj both with its kernel and with its plain loop) at
n = 2048 on the host's clock and the next 64 in a torch.profiler
window, for kernel launches, host reads, device time and the device's
idle share per join.

The last two lines are the `kernels` JSON and the contract line
{"ok": true, "device": {...}}; before them, the card's name and power
limit as nvidia-smi reports them.
"""

from __future__ import annotations

import contextlib
import functools
import gzip
import hashlib
import io
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ccphylo_tpu_torch import dryrun
from ccphylo_tpu_torch.cli import dist_cmd, tree_cmd
from ccphylo_tpu_torch.io.qseqs import Name
from ccphylo_tpu_torch.ops import build, join, matdist_torch, scan, segment, \
    segment_float, \
    snp, snp_torch
from ccphylo_tpu_torch.ops.veccmp import cmp_mats, get_veccmp, p_chisqr
from ccphylo_tpu_torch.parallel import multihost
from ccphylo_tpu_torch.parallel import sharded_dnj as sd
from ccphylo_tpu_torch.parallel import sharded_nj as snj
from ccphylo_tpu_torch.tree.exact import build_tree
from ccphylo_tpu_torch.tree import hclust_engine as he
from ccphylo_tpu_torch.tree import packed_engine as pe
from ccphylo_tpu_torch.tree import segmenting
from ccphylo_tpu_torch.tree import streamed_engine as se
from ccphylo_tpu_torch.tree import torch_engine as te

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
N_DIST, L_DIST = 2048, 1_000_000
N_SCALE, L_SCALE = 32768, 100_000
# the depths below were cut in turn as phases were added, to keep the
# script inside its time limit (PERF.md section 4)
N_DEPTH = 3072       # the float64 DNJ engine's run at depth
N_CATERPILLAR = 1024  # exact_range on a matrix that joins along a chain
N_RANDOM = 1024      # the hclust engines on the random matrix's first taxa
N_SHARDED = 4096     # the sharded DNJ engine beside the float64 engine
PROFILE_JOINS = 64   # joins under torch.profiler in the `profile` phase
TREE_METHODS = ("dnj", "upgma", "ff", "cf", "hnj", "nj", "mn")
RANDOM_METHODS = ("dnj", "upgma", "cf", "hnj")  # run on the random matrix
MISSING_METHODS = ("dnj", "upgma")  # run on the matrix with missing cells
EXP_ROWS, EXP_WORDS = 2048, 2048  # one genome chunk of the main path
PREFIX_JOINS = 1024  # plain-loop check of the phase-4 run
CHECKED_JOINS = 256  # joins of a run on which the kernels are held to plain
CHECK_SEG = 64       # joins of each dnj_segment launch held to plain
SEG_SPIN = 2_000_000  # cycles the card spins before each timed launch
PROBE_SPIN = 200_000_000  # cycles the card spins before a probe window
# dnj_segment's flag sets, timed in turns against each other: Q copied
# to shared memory (the default) or read through L2 (what runs where Q
# does not fit in shared memory)
SEG_FLAGS = {"Q": segment.STAGE_Q, "no Q": 0}
KBATCH = 128         # candidate rows per scan pass (the engine's default)
X_SCALE = 8192       # cache rows of the row-cache engine at n = N_SCALE
STREAM_JOINS = 4096  # its joins held against the packed engine's
STREAM_MORE = 1024   # its first joins, timed apart
N_STREAM, X_STREAM = 4096, 1024  # its whole run
K_MAT, L_MAT, L_MAT_SMALL = 128, 1_000_000, 100_000  # count matrices
MAT_MIN_DEPTH = 15   # dist's default -E
MAT_PAIRS = 32       # pairs held against the host's cmp_mats
Z_DEPTH = 65535      # z's gate: every total a uint16 count allows
# chi-square (1 df) critical values: z's gate flips where q crosses them
Z_CRITICAL = {0.05: 3.841458820694124, 0.01: 6.634896601021214,
              0.001: 10.827566170662733}
# the parity phase: the synthetic hash matrix of benchmarks/synth.py
# (mod 97, lo 3) at the sizes of the C reference's checked-in results
# (benchmarks/evidence/README.md); never cut
N_PARITY_Q, N_PARITY = 20_000, 100_000  # Q in shared memory; through L2
PARITY_SHA256 = {
    N_PARITY_Q: "48baa6a297644bed0108931d3b97a863c6020b779990341eaa2ea51a9a64f0bc",
    N_PARITY: "d0ee63b7659215ccdaf6b4fd5b3e7f30656ca021871d9d5e48f3adc1afc110d5"}
PARITY_NWK = "benchmarks/evidence/parity100k.c.nwck.gz"  # the C Newick
PARITY_BYTES = 3_502_515
PARITY_DIGEST = "4cd63bdaec536c37"  # the evidence's records digest
EVIDENCE_PASSES = 6.52  # scan passes a join of the evidence's (TPU) run
HASH_K = (2654435761, 40503, 2246822519)  # the hash's multipliers
M32 = 0xFFFFFFFF
HASH_ROWS = 512      # rows of the hash matrix made at once
SPOT_CELLS = 4096    # cells of it checked against the numpy hash
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
KERNEL_META = {
    "snp_expand_shared": ("ccphylo_tpu_torch/csrc/snp_expand.cu",
                          "ccphylo_tpu/ops/snp_pallas.py:69"),
    "snp_expand_pairwise": ("ccphylo_tpu_torch/csrc/snp_expand.cu",
                            "ccphylo_tpu/ops/snp_pallas.py:80"),
    # the device loop of joins _packed_segment itself: scan and body
    "dnj_segment": ("ccphylo_tpu_torch/csrc/dnj_segment.cu",
                    "ccphylo_tpu/tree/packed_engine.py:450"),
    # qrow_mins reading its rows through the slot map of a row cache
    "qrow_mins_slots": ("ccphylo_tpu_torch/csrc/qrow_mins.cu",
                        "ccphylo_tpu/ops/scan_pallas.py:49"),
    # the float engine's device loop of joins _dnj_segment (no Pallas)
    "dnj_segment_float": ("ccphylo_tpu_torch/csrc/dnj_segment_float.cu",
                          "ccphylo_tpu/tree/jax_engine.py:453"),
}
# the path whose run counts a kernel's launches in the `kernels` line,
# where it is not the main path (dist, then tree -m dnj -b through
# _dispatch_build): (its key in the results, its description)
KERNEL_PATH = {
    "qrow_mins_slots": (("streamed_launches",),
                        "the row-cache engine at n = 32768 (phase "
                        "streamed)"),
    "dnj_segment_float": (("float_path_launches",),
                          "tree -m dnj on float64 at n = 2048 through "
                          "tree_cmd._dispatch_build, the default route "
                          "(phase engines)"),
}


def log(*a):
    print("#", *a, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"


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


def as_u64_words(words32: torch.Tensor) -> torch.Tensor:
    """(n, W) int32 u32 words, hi first -> (n, W/2) int64: the .fsa
    loader's u64 words that ops/snp_torch.py reads in place."""
    n, w = words32.shape
    return words32.reshape(n, w // 2, 2).flip(-1).contiguous().view(
        torch.int64).reshape(n, w // 2)


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


def words_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two byte matrices (as int32 words), cell by
    cell, in row blocks."""
    if torch.equal(a, b):
        return 0
    a8, b8 = a.view(torch.uint8), b.view(torch.uint8)
    return max(int((a8[r:r + 1024].int() - b8[r:r + 1024].int()).abs().max())
               for r in range(0, a8.shape[0], 1024))


def join_bytes(n, m_t, i, j, q_changed) -> int:
    """Bytes a join body must move: rows i and j read, row and column j
    written, sD2 read and written, Q read over j < k < m_t, the Q and P
    entries that change written; with popArrange row `last` read and
    row and column i written over the padded width n; the records."""
    b = 4 * m_t + 8 * m_t + 4 * (m_t - j - 1) + 8 * q_changed + 40
    return b + (3 * n if i != m_t - 1 else 0)


def new_state(words8, n):
    """The packed engine's state after its init, on a copy of the byte
    matrix `words8`."""
    words = words8.clone().view(torch.int32)
    sD2, Q, P, seed = pe._packed_init(words, n)
    z = torch.zeros(words.shape[0], dtype=torch.int32, device=words.device)
    return {"words": words, "sD2": sD2, "Q": Q, "P": P, "seed": seed,
            "I": z, "J": z.clone(), "DIJ2": z.clone(), "SDI2": z.clone(),
            "SDJ2": z.clone(),
            "stats": torch.zeros(4, dtype=torch.int32, device=words.device)}


def plain_joins(st, t0, t1, n, nbytes):
    """dnj_segment_plain on state `st` over joins [t0, t1) (its scan and
    body, join by join), each join's bytes added to nbytes[0]: the
    scan's rows (`scan_bytes`) and the body's (`join_bytes`)."""
    npad = st["words"].shape[0]
    for t in range(t0, t1):
        m_t = n - t
        scanned = []

        def recording(rows, co, words, sd2):
            scanned.append(rows)
            return scan.qrow_mins_plain(rows, co, words, sd2)

        res = scan.dnj_scan_passes(st["words"], st["sD2"], st["Q"], st["P"],
                                   st["seed"], m_t, 2 * (m_t - 2), KBATCH,
                                   qrow=recording)
        Q0 = st["Q"].clone()
        join.dnj_join_plain(*(st[k] for k in pe._STATE_KEYS), res, t, m_t)
        i, j = res[:2].tolist()
        rows = torch.cat(scanned) if scanned else Q0.new_zeros(0)
        nbytes[0] += scan_bytes(rows, m_t) + 16 + join_bytes(
            npad, m_t, i, j, int((st["Q"] != Q0).sum()))


def first_joins(words8, n, joins, plain=False) -> dict:
    """The packed engine's state after its first `joins` joins on a copy
    of the byte matrix `words8`: one dnj_segment launch, or with `plain`
    the plain loop."""
    st = new_state(words8, n)
    run = segment.dnj_segment_plain if plain else segment.dnj_segment
    run(*(st[k] for k in pe._STATE_KEYS), 0, joins, n, KBATCH)
    return st


def state_err(a: dict, b: dict) -> int:
    return max(words_err(a["words"], b["words"]),
               max_abs_err([a[k] for k in pe._STATE_KEYS[1:]],
                           [b[k] for k in pe._STATE_KEYS[1:]]))


def held_to_plain(words8, n, joins, flag_sets, res, key):
    """dnj_segment with each of `flag_sets` (names of SEG_FLAGS) held to
    the plain loop over the first `joins` joins of the engine's run on a
    copy of `words8`: one launch per CHECK_SEG joins, every state array
    equal at every boundary.  Each launch is timed on the card (CUDA
    events, queued behind a spin), the flag sets in turns (forward on
    even segments, backward on odd); so is the plain version on the
    first segment, on a copy.  The bound counts each join's bytes as
    `scan_bytes` and `join_bytes` do."""
    ref = new_state(words8, n)
    sts = {f: {k: v.clone() for k, v in ref.items()} for f in flag_sets}
    preps = {f: segment.dnj_segment_prepare(
        *(sts[f][k] for k in pe._STATE_KEYS), KBATCH, flags=SEG_FLAGS[f])
        for f in flag_sets}
    seg_ms = {f: [] for f in flag_sets}
    seg_bytes, err, plain_ms = [], 0, None
    for x, t0 in enumerate(range(0, joins, CHECK_SEG)):
        t1 = min(t0 + CHECK_SEG, joins)
        if plain_ms is None:
            tmp = {k: v.clone() for k, v in ref.items()}
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            segment.dnj_segment_plain(*(tmp[k] for k in pe._STATE_KEYS),
                                      t0, t1, n, KBATCH)
            b.record()
            torch.cuda.synchronize()
            plain_ms = a.elapsed_time(b)
            del tmp
        nbytes = [0]
        plain_joins(ref, t0, t1, n, nbytes)
        seg_bytes.append(nbytes[0])
        ev = {}
        for f in (flag_sets if x % 2 == 0 else flag_sets[::-1]):
            ev[f] = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
            torch.cuda._sleep(SEG_SPIN)
            ev[f][0].record()
            segment.dnj_segment(*(sts[f][k] for k in pe._STATE_KEYS), t0, t1,
                                n, KBATCH, prep=preps[f])
            ev[f][1].record()
        torch.cuda.synchronize()
        for f in flag_sets:
            seg_ms[f].append(ev[f][0].elapsed_time(ev[f][1]))
            e = state_err(sts[f], ref)
            err = max(err, e)
            assert e == 0, f"dnj_segment ({f}) differs from its plain " \
                           f"version after joins [{t0}, {t1}) at n={n}"
    out = res[key] = {
        "joins": joins, "segments": len(seg_bytes), "max_abs_err": err,
        "flags": {f: preps[f][2] for f in flag_sets},
        "ms_per_join": {f: sum(v) / joins for f, v in seg_ms.items()},
        "first_segment_ms": {f: v[0] for f, v in seg_ms.items()},
        "first_segment_plain_ms": plain_ms,
        "first_segment_bound_ms": bytes_ms(seg_bytes[0]),
        "bound_ms_per_join": bytes_ms(sum(seg_bytes)) / joins}
    log(f"dnj_segment equals dnj_segment_plain at every boundary of "
        f"{CHECK_SEG} joins over the first {joins} joins at n={n} "
        f"({len(seg_bytes)} launches a flag set); card ms per join: "
        + ", ".join(f"{f} {v:.5f}" for f, v in out["ms_per_join"].items())
        + f"; bound {out['bound_ms_per_join']:.7f}; first segment "
        f"plain {plain_ms:.3f} ms")
    return out


def segment_breakdown(words8, n, joins, flag_sets, res, key):
    """Where a join's time goes in dnj_segment: for each of `flag_sets`,
    one launch over the first `joins` joins of a run on a copy of
    `words8` with the PROFILE flag, timed by CUDA events behind a spin;
    the SM clock cycles block 0 spent in each part of a join
    (segment.PHASES, its waits at barriers included) split that time."""
    out = res[key] = {}
    for f in flag_sets:
        st = new_state(words8, n)
        prep = segment.dnj_segment_prepare(
            *(st[k] for k in pe._STATE_KEYS), KBATCH,
            flags=SEG_FLAGS[f] | segment.PROFILE)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SEG_SPIN)
        a.record()
        segment.dnj_segment(*(st[k] for k in pe._STATE_KEYS), 0, joins, n,
                            KBATCH, prep=prep)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        cyc = segment.segment_profile(prep)
        total = sum(cyc.values())
        out[f] = {"joins": joins, "ms_per_join": ms / joins,
                  "passes_per_join": int(st["stats"][0]) / joins,
                  "us_per_join": {p: 1e3 * ms * c / total / joins
                                  for p, c in cyc.items()}}
        log(f"dnj_segment ({f}) n={n}, joins 0-{joins}: "
            f"{1e3 * ms / joins:.2f} us per join, "
            f"{out[f]['passes_per_join']:.3f} passes; " + ", ".join(
                f"{p} {v:.2f}" for p, v in out[f]["us_per_join"].items()))
        del st
    return out


def probe_segment(words8, n, res, key):
    """One dnj_segment launch of the first segment of a run on a copy of
    `words8`, with the buffers the engine prepares once a run, after the
    card has finished the run's init, measured: under
    torch.cuda.set_sync_debug_mode("error") (any host read raises),
    queued behind a spin, with CUDA events around the launch (the card's
    ms per join) and the host's clock around the wrapper's call (its µs
    per segment)."""
    joins = min(segmenting.SEG, n - 2)
    st = new_state(words8, n)
    args = [st[k] for k in pe._STATE_KEYS]
    prep = segment.dnj_segment_prepare(*args, KBATCH)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(PROBE_SPIN)
        ev[0].record()
        h0 = time.perf_counter()
        segment.dnj_segment(*args, 0, joins, n, KBATCH, prep=prep)
        host_s = time.perf_counter() - h0
        ev[1].record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launched = {k: v for k, v in build.launches.items() if v}
    assert launched == {"dnj_segment": 1}, launched
    p = res[key] = {"joins": joins, "sync_debug_error_joins": joins,
                    "card_ms_per_join": ev[0].elapsed_time(ev[1]) / joins,
                    "host_us_per_segment": 1e6 * host_s}
    log(f"device loop n={n}: one dnj_segment launch of {joins} joins under "
        f"set_sync_debug_mode('error') (no host read); on the card "
        f"{p['card_ms_per_join']:.5f} ms per join; the host's call "
        f"{p['host_us_per_segment']:.1f} us per segment")
    return p


# ---------------------------------------------------------------------
# the float engine's segment kernel (dnj_segment_float)


def float_state(D, n, exact=False):
    """The float engine's state after its init on the matrix D (updated
    in place), its exact range tracked if asked."""
    st = te._new_state(D, n)
    st["exact"] = None
    if exact:
        te.track_sums(st, n)
    return st


def float_args(st):
    return [st.get(k) for k in segment_float.STATE_KEYS]


def float_err(a: dict, b: dict, rel=False,
              keys=segment_float.STATE_KEYS) -> float:
    """The largest difference of two float-engine states over the arrays
    `keys`: |x - y|, 0 where the two are equal (the matrix compared in
    row blocks), or with `rel` |x - y| / max(|y|, 1)."""
    err = 0.0
    for k in keys:
        x, y = a[k], b[k]
        if x is None or torch.equal(x, y):
            continue
        x2, y2 = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
        for r in range(0, x2.shape[0], 1024):
            xs, ys = x2[r:r + 1024].double(), y2[r:r + 1024].double()
            d = torch.where(xs == ys, 0.0, (xs - ys).abs())
            if rel:
                d = d / ys.abs().clamp_min(1.0)
            err = max(err, float(d.max()))
    return err


def float_join_bytes(m_t, passes, tb, pop, q_changed) -> int:
    """Bytes join t of the float engine must move, `tb` bytes a float:
    per scan pass (`passes`, the rows of each) the c < r prefix of each
    row's cells, sD and N under the longest prefix, Q of the m_t rows
    and three results a row; the body: rows i, j (and last, with
    popArrange) read, row and column j (and i) written, sD and N read and
    written, the changed Q and P entries, the records."""
    nbytes = 0
    for rows in passes:
        r = rows.long()
        nbytes += int(r.sum()) * tb + int(r.max()) * (tb + 4) \
            + m_t * tb + 12 * r.numel()
    return nbytes + (4 + 3 * pop) * m_t * tb + 2 * m_t * (tb + 4) \
        + q_changed * (tb + 4) + 8 + 2 * tb


def plain_float_joins(st, t0, t1, n) -> int:
    """dnj_segment_float_plain on `st` over joins [t0, t1), join by join,
    the rows of each scan pass noted; returns their bytes
    (`float_join_bytes`).  Stops at a join where the exact range ends."""
    real, scanned, nbytes = te._batch_scan, [], 0
    tb = st["D"].element_size()

    def recording(block_q, *a, **k):
        def noted(rows):
            scanned.append(rows)
            return block_q(rows)
        return real(noted, *a, **k)

    te._batch_scan = recording
    try:
        for t in range(t0, t1):
            del scanned[:]
            Q0 = st["Q"].clone()
            segment_float.dnj_segment_float_plain(*float_args(st), t, t + 1,
                                                  n)
            if int(st["first_inexact"]) >= 0:
                break
            m_t = n - t
            nbytes += float_join_bytes(
                m_t, scanned, tb, int(st["I"][t]) != m_t - 1,
                int((st["Q"] != Q0).sum()))
    finally:
        te._batch_scan = real
    return nbytes


def held_float(D, n, joins, res, key, exact=False, rtol=0.0, flags=None):
    """dnj_segment_float held to dnj_segment_float_plain on the card over
    the first `joins` joins of a run on the matrix D (the plain loop's;
    the kernel runs on a copy): one launch per CHECK_SEG joins, compared
    at every boundary: every state array equal (`float_err` 0), or,
    with rtol (sums outside the exact range, in another order), the
    picks I, J and the counts N equal and the limbs within rtol of
    max(|x|, 1), the largest relative difference of D, sD and Q
    printed.  With
    `exact`, the exact range is tracked and a join where it ends stops
    both loops, at the same join, and the check.  Each launch is timed
    on the card (CUDA events, queued behind a spin), the plain loop on
    the first segment on a copy; the bound counts each join's bytes
    (`float_join_bytes`).  `flags`: the kernel's design
    (`dnj_segment_float_prepare`'s default if None); the top-ups of the
    candidate list are counted."""
    st = float_state(D.clone(), n, exact)
    prep = segment_float.dnj_segment_float_prepare(*float_args(st), n,
                                                   flags=flags)
    ref = float_state(D, n, exact)
    seg_ms, seg_bytes, err, stop, plain_ms = [], [], 0.0, -1, None
    state_diff = 0.0
    for t0 in range(0, joins, CHECK_SEG):
        t1 = min(t0 + CHECK_SEG, joins)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if plain_ms is None:
            tmp = {k: v.clone() if isinstance(v, torch.Tensor) else v
                   for k, v in ref.items()}
            a.record()
            segment_float.dnj_segment_float_plain(*float_args(tmp), t0, t1,
                                                  n)
            b.record()
            torch.cuda.synchronize()
            plain_ms = a.elapsed_time(b)
            del tmp
        seg_bytes.append(plain_float_joins(ref, t0, t1, n))
        torch.cuda._sleep(SEG_SPIN)
        a.record()
        segment_float.dnj_segment_float(*float_args(st), t0, t1, n,
                                        prep=prep)
        b.record()
        torch.cuda.synchronize()
        seg_ms.append(a.elapsed_time(b))
        if rtol:
            for k in ("I", "J", "N"):
                assert torch.equal(st[k], ref[k]), f"{k} after [{t0}, {t1})"
            e = float_err(st, ref, True, ("LI", "LJ"))
            state_diff = max(state_diff,
                             float_err(st, ref, True, ("D", "sD", "Q")))
        else:
            e = float_err(st, ref)
        err = max(err, e)
        assert e <= rtol, f"dnj_segment_float differs from its plain " \
                          f"version after joins [{t0}, {t1}) at n={n}: {e}"
        stops = int(st["first_inexact"]), int(ref["first_inexact"])
        assert stops[0] == stops[1], stops
        if stops[0] >= 0:
            stop = stops[0]
            break
    done = stop if stop >= 0 else joins
    out = res[key] = {
        "n": n, "dtype": str(D.dtype), "flags": prep[2], "joins": done,
        "segments": len(seg_ms), "rtol": rtol,
        ("limbs_max_rel_err" if rtol else "max_abs_err"): err,
        "state_max_rel_diff": state_diff,
        "exact_range_ends_at_join": stop,
        "ms_per_join": sum(seg_ms) / max(done, 1),
        "first_segment_ms": seg_ms[0], "first_segment_plain_ms": plain_ms,
        "first_segment_bound_ms": bytes_ms(seg_bytes[0]),
        "bound_ms_per_join": bytes_ms(sum(seg_bytes)) / max(done, 1),
        "refills": segment_float.segment_float_refills(prep)}
    log(f"dnj_segment_float ({D.dtype}, flags {prep[2]}, "
        f"{out['refills']} refills of the list) equals "
        f"dnj_segment_float_plain at every boundary of {CHECK_SEG} joins "
        f"over the first {done} joins at n={n} ("
        + (f"picks equal, limbs within {rtol} of max(|x|, 1): largest "
           f"{err:.3g}; D, sD and Q within {state_diff:.3g}" if rtol
           else f"max_abs_err {err}")
        + (f"; both stop where the exact range ends, join {stop}"
           if stop >= 0 else "")
        + f"); card ms per join {out['ms_per_join']:.5f}, bound "
        f"{out['bound_ms_per_join']:.7f}; first segment {seg_ms[0]:.3f} "
        f"ms, plain {plain_ms:.3f} ms")
    del st, ref
    return out


@contextlib.contextmanager
def float_build(key):
    """dnj_segment_float launched from the build `key` (a
    `build.variant` of its source; None: the source's) inside the
    block."""
    old = segment_float.STEM
    segment_float.STEM = key or old
    try:
        yield
    finally:
        segment_float.STEM = old


def float_breakdown(D, n, joins, turns, res, key):
    """dnj_segment_float's designs in turns, and where a join's time goes
    in each: for each (name, prepare's keywords, and "build": a
    `build.variant` of the kernel) of `turns`, in order, one launch over
    the first `joins` joins of a run on a copy of D, timed by CUDA
    events behind a spin, then the same launch with the PROFILE flag:
    the SM clock cycles block 0 spent in each part of a join
    (segment_float.PHASES, its waits at barriers included) split the
    first launch's time."""
    out = res[key] = {}
    for name, kw in turns:
        kw = dict(kw)
        with float_build(kw.pop("build", None)):
            r = float_breakdown_turn(D, n, joins, name, kw)
        out.setdefault(name, []).append(r)
    return out


def float_breakdown_turn(D, n, joins, name, kw) -> dict:
    """One turn of `float_breakdown`: `dnj_segment_float_prepare`'s
    keywords `kw`, the build segment_float.STEM."""
    ms = {}
    for prof in (0, segment_float.PROFILE):
        st = float_state(D.clone(), n)
        kw2 = dict(kw)
        if prof:
            kw2["flags"] = segment_float.prepare_flags(
                st["D"], n, kw.get("flags")) | prof
        prep = segment_float.dnj_segment_float_prepare(*float_args(st), n,
                                                       **kw2)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SEG_SPIN)
        a.record()
        segment_float.dnj_segment_float(*float_args(st), 0, joins, n,
                                        prep=prep)
        b.record()
        torch.cuda.synchronize()
        ms[prof] = a.elapsed_time(b)
        del st
    cyc = segment_float.segment_float_profile(prep)
    total = sum(cyc.values())
    # every block's cycles by part, at block 0's rate: the slowest
    # block's and the mean
    blk = segment_float.segment_float_block_profile(prep).double() \
        * (1e3 * ms[prof] / total / joins)
    r = {"joins": joins, "dtype": str(D.dtype), "flags": prep[2],
         "blocks_max_us": dict(zip(segment_float.PHASES,
                                   blk.max(0).values.tolist())),
         "blocks_mean_us": dict(zip(segment_float.PHASES,
                                    blk.mean(0).tolist())),
         "build": segment_float.STEM, "ms_per_join": ms[0] / joins,
         "profiled_ms_per_join": ms[prof] / joins,
         "refills": segment_float.segment_float_refills(prep),
         "us_per_join": {p: 1e3 * ms[0] * c / total / joins
                         for p, c in cyc.items() if c}}
    log(f"dnj_segment_float ({name}, {D.dtype}, flags {prep[2]}) n={n}, "
        f"joins 0-{joins}: {1e3 * ms[0] / joins:.2f} us per join "
        f"({1e3 * ms[prof] / joins:.2f} with PROFILE, {r['refills']} "
        "refills); " + ", ".join(
            f"{p} {v:.2f}" for p, v in r["us_per_join"].items())
        + "; over the blocks, mean / max: " + ", ".join(
            f"{p} {r['blocks_mean_us'][p]:.2f} / "
            f"{r['blocks_max_us'][p]:.2f}" for p in r["us_per_join"]))
    return r


def float_agreement(D, n, joins, res, key):
    """dnj_segment_float and dnj_segment_float_plain, untracked, over the
    first `joins` joins on copies of D, one launch and one plain segment:
    where sums leave the exact range they run in other orders, so the
    first join whose pick differs and the largest relative difference
    of the limbs before it are printed, not asserted."""
    st, ref = float_state(D.clone(), n), float_state(D, n)
    segment_float.dnj_segment_float(*float_args(st), 0, joins, n)
    segment_float.dnj_segment_float_plain(*float_args(ref), 0, joins, n)
    same = ((st["I"] == ref["I"]) & (st["J"] == ref["J"]))[:joins].cpu()
    first = joins if bool(same.all()) else int((~same).int().argmax())
    lim = {k: v[:first] for k, v in st.items() if k in ("LI", "LJ")}
    rl = {k: v[:first] for k, v in ref.items() if k in ("LI", "LJ")}
    out = res[key] = {"n": n, "dtype": str(D.dtype), "joins": joins,
                      "picks_equal_to_join": first,
                      "limbs_max_rel_diff": float_err(lim, rl, True,
                                                      ("LI", "LJ"))}
    log(f"dnj_segment_float ({D.dtype}) untracked at n={n}: picks equal to "
        f"the plain loop's for the first {first} of {joins} joins, limbs "
        f"within {out['limbs_max_rel_diff']:.3g} of max(|x|, 1) there")
    del st, ref
    return out


def float_tree_at_scale(D8, n, res):
    """The whole tree at n in float64 on the integer matrix D8: first the
    engine with the exact range tracked, as the default route runs it,
    on the card alone (the join where the run leaves the range, if it
    does); then through build_tree_float untracked (the route of
    CCPHYLO_TORCH_ENGINE=device64): the seconds of the host's part (the
    square matrix and its upload), of the engine's init and of its
    joins, and of the Newick; joins/s, launches and the peak memory on
    the card; the tree's shape asserted."""
    try:
        te.dnj_joins(D8.double(), n, exact_sums=True)
        stop = None
    except te.InexactSums as e:
        stop = e.join
    torch.cuda.empty_cache()
    iu = torch.tril_indices(n, n, -1, device=D8.device)
    flat = D8[iu[0], iu[1]].double().cpu().numpy()
    del iu
    times, out = {}, {}
    real = {k: getattr(te, k) for k in ("dnj_joins", "_new_state",
                                          "_records_to_newick")}

    def timed(name):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = real[name](*a, **k)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            return out[name]
        return call

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    for k in real:
        setattr(te, k, timed(k))
    try:
        nwk, t = synced(lambda: te.build_tree_float(
            flat, n, iso_names(n), dtype=torch.float64))
    finally:
        for k, v in real.items():
            setattr(te, k, v)
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in build.launches.items() if v}
    assert launches == {"dnj_segment_float": -(-(n - 2) // segmenting.SEG)}, \
        launches
    I, J = out["dnj_joins"][0][:n - 2], out["dnj_joins"][1][:n - 2]
    assert_tree_shape(nwk, I, J, n)
    engine_s = times["dnj_joins"] - times["_new_state"]
    r = res[f"float_tree_{n}"] = {
        "n": n, "s": t, "joins_per_s": (n - 2) / engine_s,
        "init_s": times["_new_state"], "engine_s": engine_s,
        "newick_s": times["_records_to_newick"],
        "host_s": t - times["dnj_joins"] - times["_records_to_newick"],
        "launches": launches, "peak_bytes": peak,
        "exact_range_ends_at_join": stop, "newick_bytes": len(nwk)}
    log(f"tree n={n} -m dnj float64 through build_tree_float: {t:.1f} s; "
        f"engine {engine_s:.3f} s, {r['joins_per_s']:,.1f} joins/s, init "
        f"{r['init_s']:.3f} s, square matrix and upload {r['host_s']:.1f} "
        f"s, Newick {r['newick_s']:.1f} s; launches {launches}; peak "
        f"device memory {peak / 2 ** 30:.2f} GiB; tracked, the run "
        + ("keeps float64's exact range to the end" if stop is None else
           f"leaves float64's exact range before join {stop} (the default "
           "route would hand it to the host engine there)"))
    return r


def list_flags(n: int) -> int:
    """The flags of dnj_segment_float's candidate-list design at n rows
    (what the default takes from segment_float.ROWS_BELOW taxa on)."""
    return segment_float.default_design(n, max(n, segment_float.ROWS_BELOW))


def float_turns_of(n: int) -> list:
    """dnj_segment_float's two designs in turns for `float_breakdown`:
    the candidate list, the first design (ROWS), the same, the list."""
    lst, rows = ("list", {"flags": list_flags(n)}), \
        ("rows", {"flags": segment_float.ROWS})
    return [lst, rows, rows, lst]


def float_at_scale(D8, n, res):
    """dnj_segment_float on the float64 copy of the integer matrix D8 (n
    = 32768: 8.6 GB): held to its plain version every CHECK_SEG joins of
    the first CHECKED_JOINS in the default design, the candidate list
    (its first launch the `kernels` line's; its list overflows there:
    top-ups from the slices of Q, asserted), and in the first design
    (ROWS); the two designs timed in turns, and where a join's time goes
    in each (`float_breakdown`); the float32 instance held the same
    way in both designs with the exact range tracked (bit-equal until
    both stop where it ends), then untracked beside the plain loop
    (`float_agreement`); then the whole tree in float64."""
    D64 = D8.double()
    h = held_float(D64.clone(), n, CHECKED_JOINS, res,
                   f"segment_float_check_{n}")
    assert h["flags"] & segment_float.ROWS == 0, h["flags"]
    assert h["refills"] > 0, h  # the list overflowed: its top-ups held
    res.setdefault("max_abs_err", {})["dnj_segment_float"] = max(
        res["max_abs_err"].get("dnj_segment_float", 0), h["max_abs_err"])
    res.setdefault("kernel_ms", {})["dnj_segment_float"] = (
        h["first_segment_ms"], h["first_segment_plain_ms"])
    res.setdefault("bound_ms", {})["dnj_segment_float"] = \
        h["first_segment_bound_ms"]
    x = held_float(D64.clone(), n, CHECKED_JOINS, res,
                   f"segment_float_check_{n}_rows", flags=segment_float.ROWS)
    res["max_abs_err"]["dnj_segment_float"] = max(
        res["max_abs_err"]["dnj_segment_float"], x["max_abs_err"])
    float_breakdown(D64, n, CHECKED_JOINS, float_turns_of(n), res,
                    f"float_breakdown_{n}")
    del D64
    torch.cuda.empty_cache()
    for key, kw in (("", {}), ("_rows", {"flags": segment_float.ROWS})):
        h32 = held_float(D8.float(), n, CHECKED_JOINS, res,
                         f"segment_float_check_{n}_float32{key}", exact=True,
                         **kw)
        res["max_abs_err"]["dnj_segment_float"] = max(
            res["max_abs_err"]["dnj_segment_float"], h32["max_abs_err"])
    float_agreement(D8.float(), n, CHECKED_JOINS, res,
                    f"segment_float_agreement_{n}_float32")
    torch.cuda.empty_cache()
    float_tree_at_scale(D8, n, res)


def float_whole_run(D, n, flags, res, key, build_key=None):
    """A whole float64 run of dnj_segment_float at n on a copy of D in
    the design `flags` (from the build `build_key`, a `build.variant`;
    None: the source's), one launch a segment of segmenting.SEG joins,
    each timed by CUDA events and split by part (PROFILE): us, passes and
    top-ups of the candidate list a join, by segment."""
    st = float_state(D.clone(), n)
    with float_build(build_key):
        prep = segment_float.dnj_segment_float_prepare(
            *float_args(st), n, flags=flags | segment_float.PROFILE)
        rows, prev, passes0, refills0 = [], None, 0, 0
        for t0 in range(0, n - 2, segmenting.SEG):
            t1 = min(t0 + segmenting.SEG, n - 2)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            segment_float.dnj_segment_float(*float_args(st), t0, t1, n,
                                            prep=prep)
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b)
            cyc = segment_float.segment_float_profile(prep)
            d = {p: c - (prev[p] if prev else 0) for p, c in cyc.items()}
            prev, tot = cyc, sum(d.values())
            passes = int(st["stats"][0])
            refills = segment_float.segment_float_refills(prep)
            rows.append({"t0": t0, "ms": ms,
                         "us_per_join": 1e3 * ms / (t1 - t0),
                         "passes_per_join": (passes - passes0) / (t1 - t0),
                         "refills": refills - refills0,
                         "us_per_join_by_part": {
                             p: 1e3 * ms * c / tot / (t1 - t0)
                             for p, c in d.items() if c}})
            passes0, refills0 = passes, refills
    out = res.setdefault(key, [])
    r = {"n": n, "flags": prep[2], "build": build_key or "source",
         "s": sum(x["ms"] for x in rows) / 1e3, "refills": refills,
         "passes_per_join": passes / (n - 2), "segments": rows}
    out.append(r)
    log(f"dnj_segment_float whole run n={n}, flags {prep[2]}, build "
        f"{r['build']}: {r['s']:.3f} s, {r['passes_per_join']:.3f} passes "
        f"and {refills / (n - 2):.3f} top-ups a join; us a join by "
        "segment: " + ", ".join(f"{x['t0']}: {x['us_per_join']:.1f}"
                                for x in rows[::4]))
    del st, prep
    return r


# the kernel's constants timed in turns with the source's (kListK 1,
# kPieceUnits 2048) by `phase_float_sizes`: (name, the -D macros)
FLOAT_CONSTANTS = (("list 2K", {"DNJ_FLOAT_LIST_K": 2}),
                   ("list 4K", {"DNJ_FLOAT_LIST_K": 4}),
                   ("piece 512", {"DNJ_FLOAT_PIECE_UNITS": 512}),
                   ("piece 8192", {"DNJ_FLOAT_PIECE_UNITS": 8192}))


def phase_float_sizes(dev, res):
    """Only when named: dnj_segment_float's designs in turns where the
    default switches between them (`float_breakdown`, first SEG joins):
    ROWS and the list (list, rows, rows, list) on outbreak matrices of
    n = 2048 (1 Mbp), 2560, 3072, 4096 (100 kbp) taxa around
    segment_float.ROWS_BELOW; the list from the copy of Q and from
    slices of Q (stage, slices, slices, stage) on the first 8192, 16384
    and 24576 taxa of the scale matrix (float64), around STAGE_Q_ROWS.
    Then builds of the kernel with other constants (FLOAT_CONSTANTS)
    and the source's, in turns (the source first and last): at n = 4096
    on the first SEG joins, and whole float64 runs at N_SCALE
    (`float_whole_run`), after a whole run there in each of ROWS and
    the list."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    for n in (2048, 2560, 3072, 4096):
        flat = snp_flat(dev, g, n, L_DIST if n == 2048 else L_SCALE)
        D = torch.from_numpy(te.square_matrix(flat, n)).to(dev)
        float_breakdown(D, n, min(segmenting.SEG, n - 2), float_turns_of(n),
                        res, f"float_sizes_{n}")
        if n == 4096:
            D4 = D
        del D
    g.manual_seed(SEED)
    D64 = scale_matrix(dev, g).double()
    for n in (8192, 16384, 24576):
        stage = ("stage", {"flags": segment_float.STAGE_Q})
        slices = ("slices", {"flags": 0})
        float_breakdown(D64[:n, :n].contiguous(), n, segmenting.SEG,
                        [stage, slices, slices, stage], res,
                        f"float_stage_{n}")
    for name, flags in (("list", list_flags(N_SCALE)),
                        ("rows", segment_float.ROWS)):
        float_whole_run(D64, N_SCALE, flags, res,
                        f"float_whole_run_{N_SCALE}_{name}")
    keys = [("source", None)] + [
        (name, build.variant("dnj_segment_float", **d))
        for name, d in FLOAT_CONSTANTS]
    order = keys + keys[::-1]
    float_breakdown(D4, 4096, segmenting.SEG,
                    [(name, {"flags": list_flags(4096), "build": key})
                     for name, key in order], res, "float_constants_4096")
    del D4
    for name, key in order:
        float_whole_run(D64, N_SCALE, list_flags(N_SCALE), res,
                        f"float_constants_{N_SCALE}_{name}", key)


# `dist_ring`: the cell's staging of a fill's rows, (name, snp_torch
# constants) of the ring variants timed in turns with the others
RING_VARIANTS = (("ring", {}),
                 ("ring 1 thread", {"COPY_THREADS": 1}),
                 ("ring 2 threads", {"COPY_THREADS": 2}),
                 ("ring 6 threads", {"COPY_THREADS": 6}),
                 ("ring 8 threads", {"COPY_THREADS": 8}),
                 ("ring 32 MiB", {"SLOT_BYTES": 32 << 20}),
                 ("ring 128 MiB", {"SLOT_BYTES": 128 << 20}),
                 ("ring 2 slots", {"RING_SLOTS": 2}))
N_RING, W64_RING = 2282, 88_168   # mrsa-2282: 2.82 Mbp, 32 bases a word


def phase_dist_ring(dev, res):
    """Only when named: how a dist fill's rows reach the card, at
    mrsa-2282's size (N_RING samples of W64_RING u64 words and as many
    u32 include words, each its own array), in turns (forward, then
    backward, four rounds): the np.stack, pageable upload and pad copy
    on the card that the seams made before `padded_rows`; one pageable
    copy_ a row into the padded buffer; `padded_rows`' pinned ring with
    its constants and with those of RING_VARIANTS.  Each time ends with
    the buffers on the card (synchronised); "words" stages the sample
    words (a shared-mask fill), "both" the words then the include words
    (a per-sample fill).  Before any of them, the first ring fill of the
    process, which allocates the pinned slots, and that allocation
    again after the caching host allocator is emptied."""
    n, W64 = N_RING, W64_RING
    npad = snp_torch._padded(n)[1]
    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 2 ** 63, (64, W64), dtype=np.int64)
    words = [base[i % 64].view(np.uint64).copy() for i in range(n)]
    incs = [base[i % 64].view(np.uint32)[::2].copy() for i in range(n)]
    assert incs[0].shape == (W64,)
    del base

    def stack(rows):
        S = np.stack(rows)
        t = (snp_torch.u64_tensor(S, dev) if S.dtype == np.uint64
             else snp_torch.u32_tensor(S, dev))
        return snp_torch._pad_rows(t, npad)

    def row_copy(rows):
        signed = np.int64 if rows[0].dtype == np.uint64 else np.int32
        buf = torch.empty((npad, W64), device=dev, dtype=torch.int64
                          if signed is np.int64 else torch.int32)
        buf[n:].zero_()
        for j, r in enumerate(rows):
            buf[j].copy_(torch.from_numpy(r.view(signed)))
        return buf

    def ring(consts):
        def run(rows):
            old = {k: getattr(snp_torch, k) for k in consts}
            for k, v in consts.items():
                setattr(snp_torch, k, v)
            try:
                return snp_torch.padded_rows(rows, dev)
            finally:
                for k, v in old.items():
                    setattr(snp_torch, k, v)
        return run

    out = res.setdefault("dist_ring", {})
    first, t = synced(lambda: snp_torch.padded_rows(words, dev))
    assert np.array_equal(first[:n].cpu().numpy().view(np.uint64)[::97],
                          np.stack(words[::97]))
    del first
    out["first_fill_words_s"] = t
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        allocs = []
        for _ in range(3):
            torch.cuda.synchronize()
            empty()
            allocs.append(synced(lambda: snp_torch.padded_rows(words,
                                                               dev))[1])
        out["fresh_pinned_fill_words_s"] = allocs
    variants = [("stack", stack), ("row_copy", row_copy)] + [
        (name, ring(c)) for name, c in RING_VARIANTS]
    times = {f"{name} {what}": [] for name, _ in variants
             for what in ("words", "both")}
    for r in range(4):
        for name, fn in (variants if r % 2 == 0 else variants[::-1]):
            times[f"{name} words"].append(synced(lambda: fn(words))[1])
            times[f"{name} both"].append(
                synced(lambda: (fn(words), fn(incs)))[1])
    out["times_s"] = times
    log(f"dist_ring n={n} W64={W64}: first fill {t:.4f} s; fresh pinned "
        f"{out.get('fresh_pinned_fill_words_s')}")
    for k, v in times.items():
        log(f"  {k}: median {float(np.median(v)):.4f} s, "
            f"{' '.join(f'{x:.4f}' for x in v)}")


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions


def phase_kernels(dev, g, res):
    # qrow_mins without slots: no path launches it, but it is held and
    # timed here as the kernel that qrow_mins_slots is held against
    err = {k: 0 for k in (*KERNEL_META, "qrow_mins")}
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
    # the same words in the loader's u64 layout (int64, read at index
    # w ^ 1) expand to the same bytes: whole, and a slice of whole u64
    # words (an even start and width)
    big64 = as_u64_words(big)
    full = rand_words((nr, EXP_WORDS))
    w2 = (wr + 1) // 2
    rag32, rag64 = full[:, 14:14 + 2 * w2], as_u64_words(full)[:, 7:7 + w2]
    rag_m = (rand_words((nr, EXP_WORDS)) & pair)[:, 14:14 + 2 * w2]
    for s32, s64, p, m in ((big, big64, pm, masks),
                           (rag32, rag64, pm[14:14 + 2 * w2], rag_m)):
        err["snp_expand_shared"] = max(err["snp_expand_shared"], max_abs_err(
            [snp_torch.expand_shared(s64, p)],
            [snp_torch.expand_shared(s32, p)]))
        err["snp_expand_pairwise"] = max(
            err["snp_expand_pairwise"],
            max_abs_err(snp_torch.expand_pairwise(s64, m),
                        snp_torch.expand_pairwise(s32, m)))
    # the loader's u32 include words (one per u64 sample word) as the
    # pairwise kernel's masks expand to the bytes of their pair masks,
    # on both word layouts
    inc = rand_words((EXP_ROWS, EXP_WORDS // 2))
    inc_pm = snp_torch.u32_tensor(snp_torch.inc32_to_pairmask(
        inc.cpu().numpy().view(np.uint32)), dev)
    for s in (big, big64):
        err["snp_expand_pairwise"] = max(
            err["snp_expand_pairwise"],
            max_abs_err(snp_torch.expand_pairwise(s, inc),
                        snp_torch.expand_pairwise(s, inc_pm)))
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
    # the shared kernel on the two word layouts in turns (u32, u64, u64,
    # u32, ...): the same bytes, the u64 words read at index w ^ 1
    res["expand_shared_layouts_ms"] = [
        [name, cuda_ms(lambda: snp_torch.expand_shared(w, pm), 50)]
        for _ in range(3)
        for name, w in (("u32", big), ("u64", big64), ("u64", big64),
                        ("u32", big))]
    # the pairwise kernel on the loader's u64 words with pair masks and
    # with include words in turns (pair, inc, inc, pair, ...)
    res["expand_pairwise_masks_ms"] = [
        [name, cuda_ms(lambda: snp_torch.expand_pairwise(big64, m), 50)]
        for _ in range(3)
        for name, m in (("pair", inc_pm), ("inc", inc), ("inc", inc),
                        ("pair", inc_pm))]
    del big, big64, masks, rag, rag32, rag64, full, rag_m, inc, inc_pm

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
    # the same kernel on a cache of X rows: row r at cache[slotof[r]]
    X = X_SCALE
    resident = torch.randperm(n, device=dev, generator=g)[:X]
    slotof = torch.full((n,), -1, dtype=torch.int32, device=dev)
    slotof[resident] = torch.randperm(X, device=dev, generator=g).int()
    cache = words[:X]  # any words will do: both versions read the same
    srows = resident[:128].int().contiguous()
    spad = srows.clone()
    spad[::3] = 0
    absent = torch.nonzero(slotof < 0)[1:129, 0].int().contiguous()
    for r in (srows, spad, absent):
        err["qrow_mins_slots"] = max(err["qrow_mins_slots"], max_abs_err(
            scan.qrow_mins(r, co, cache, sd2, slots=slotof),
            scan.qrow_mins_plain(r, co, cache, sd2, slots=slotof)))
    # against the slot-free kernel on the rows laid out in full
    full = torch.zeros_like(words)
    full[resident.long()] = cache[slotof[resident.long()].long()]
    err["qrow_mins_slots"] = max(err["qrow_mins_slots"], max_abs_err(
        scan.qrow_mins(srows, co, cache, sd2, slots=slotof),
        scan.qrow_mins(srows, co, full, sd2)))
    del full
    t["qrow_mins_slots"] = (
        cuda_ms(lambda: scan.qrow_mins(srows, co, cache, sd2, slots=slotof),
                50),
        cuda_ms(lambda: scan.qrow_mins_plain(srows, co, cache, sd2,
                                             slots=slotof), 10))
    bound["qrow_mins_slots"] = bytes_ms(scan_bytes(srows, 0) + 4 * 128)
    del cache, slotof
    words.fill_(0x05050505)  # every cell 5: every column ties
    sd2.zero_()
    rmin, rarg = scan.qrow_mins(rows, 10, words, sd2)
    assert torch.equal(rarg, rows - 1) and bool((rmin == 50).all())
    err["qrow_mins"] = max(err["qrow_mins"], max_abs_err(
        (rmin, rarg), scan.qrow_mins_plain(rows, 10, words, sd2)))
    del words, sd2

    # the segment kernel (each of its flag sets) from an all-tie matrix
    # (every cell 5, so every cached Q ties): the whole engine run at
    # n = 2048, then the first joins at n = 32768, against the plain
    # loop every CHECK_SEG joins
    for n, joins in ((N_DIST, N_DIST - 2), (N_SCALE, CHECKED_JOINS)):
        tie = torch.full((n, n), 5, dtype=torch.uint8, device=dev)
        tie.fill_diagonal_(0)
        h = held_to_plain(tie, n, joins, list(SEG_FLAGS), res,
                          f"segment_check_ties_{n}")
        err["dnj_segment"] = max(err["dnj_segment"], h["max_abs_err"])
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
    sequences, u32 include words; each row copied into a padded card
    buffer through the pinned ring, the shared mask's host conversion,
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
    assert build.launches["dnj_segment"] == -(-(n - 2) // segmenting.SEG) \
        and build.launches["qrow_mins"] == 0, build.launches
    seg_passes = int(pe.dnj_joins_packed.last_stats[0])
    split = res["tree_seam_split_s"] = dict(pe.build_tree_packed.last_times)
    split["other"] = t_tree - sum(split.values())
    pairs = n * (n - 1) / 2
    res["dist_shared_s"], res["dist_pairwise_s"] = t_dist, t_pair
    res["dist_sample_pairs_per_s"] = pairs / t_dist
    res["dist_pairwise_sample_pairs_per_s"] = pairs / t_pair
    res["tree_s"], res["tree_joins_per_s"] = t_tree, (n - 2) / t_tree
    log(f"dist seam, shared mask: {t_dist:.3f} s, {pairs / t_dist:,.0f} "
        f"sample-pairs/s; per-sample masks: {t_pair:.3f} s, "
        f"{pairs / t_pair:,.0f} sample-pairs/s")
    log(f"tree seam -m dnj -b: {t_tree:.3f} s, {(n - 2) / t_tree:,.0f} "
        f"joins/s, scan passes {seg_passes}, dnj_segment launches "
        f"{build.launches['dnj_segment']}; "
        "seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))

    D8 = torch.from_numpy(np.clip(Dh, 0, 255).astype(np.uint8)).to(dev)
    D8 = torch.nn.functional.pad(D8, (0, pe.pad_packed(n) - n,
                                      0, pe.pad_packed(n) - n))
    # dnj_segment against its plain version at every boundary of
    # CHECK_SEG joins of this tree; then one segment's card time and
    # host time, with no host read
    err = res.setdefault("max_abs_err", {})
    h = held_to_plain(D8, n, n - 2, list(SEG_FLAGS), res,
                      f"segment_check_{n}")
    err["dnj_segment"] = max(err.get("dnj_segment", 0), h["max_abs_err"])
    probe_segment(D8, n, res, f"segment_probe_{n}")
    segment_breakdown(D8, n, min(segmenting.SEG, n - 2),
                      list(SEG_FLAGS),
                      res, f"segment_breakdown_{n}")
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

    t0 = time.perf_counter()
    # bytescale 1.0: the CLI default of -b (build_tree defaults to 128)
    nwk_host = build_tree(flat.copy(), n, names(), "dnj", dtype="b",
                          bytescale=1.0)
    res["tree_host_exact_s"] = time.perf_counter() - t0
    assert nwk == nwk_host, "Newick differs from the host exact -b engine"
    log(f"Newick ({len(nwk)} bytes) equals the host exact -b engine's "
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
    launches = build.launches["dnj_segment"]
    assert {k: v for k, v in build.launches.items() if v} \
        == {"dnj_segment": -(-(n - 2) // segmenting.SEG)}, build.launches
    I, J = out[0].cpu().numpy()[:n - 2], out[1].cpu().numpy()[:n - 2]
    m_t = n - np.arange(n - 2)
    assert ((J >= 0) & (J < I) & (I < m_t)).all(), "bad join records"
    res["scale_n"], res["scale_s"] = n, t
    res["scale_joins_per_s"] = (n - 2) / t
    res["scale_segment_launches"] = launches
    res["scale_scan_passes"] = int(pe.dnj_joins_packed.last_stats[0])
    log(f"packed engine n={n}: {t:.1f} s, {(n - 2) / t:,.1f} joins/s, "
        f"{launches} dnj_segment launches, "
        f"{res['scale_scan_passes']} passes "
        f"({res['scale_scan_passes'] / (n - 2):.3f} per join)")
    del words
    # dnj_segment against its plain version at every boundary of
    # CHECK_SEG joins of the first CHECKED_JOINS; its first launch, of
    # the default flags, is the `kernels` line's
    h = held_to_plain(D8, n, CHECKED_JOINS, list(SEG_FLAGS), res,
                      f"segment_check_{n}")
    err = res.setdefault("max_abs_err", {})
    err["dnj_segment"] = max(err.get("dnj_segment", 0), h["max_abs_err"])
    default = next(f for f, v in SEG_FLAGS.items() if v == segment.FLAGS)
    res.setdefault("kernel_ms", {})["dnj_segment"] = (
        h["first_segment_ms"][default], h["first_segment_plain_ms"])
    res.setdefault("bound_ms", {})["dnj_segment"] = \
        h["first_segment_bound_ms"]
    probe_segment(D8, n, res, f"segment_probe_{n}")
    segment_breakdown(D8, n, segmenting.SEG,
                      list(SEG_FLAGS),
                      res, f"segment_breakdown_{n}")

    # the first joins again with the plain loop, on the untouched matrix
    k = PREFIX_JOINS
    prefix = first_joins(D8, n, k, plain=True)
    for name, ours in zip(("I", "J", "DIJ2", "SDI2", "SDJ2"), out[:5]):
        np.testing.assert_array_equal(prefix[name][:k].cpu().numpy(),
                                      ours.cpu().numpy()[:k], err_msg=name)
    del prefix
    log(f"first {k} joins equal the plain loop's")
    # the float engine's segment kernel on this matrix in float64 (and
    # float32), then its whole tree
    float_at_scale(D8, n, res)
    return D8


# ---------------------------------------------------------------------
# phase parity: the packed engine at n = 20,000 and 100,000 on the
# synthetic hash matrix, byte-equal to the C reference's Newick


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2**32 for int64 x in [0, 2**32) and k < 2**32, in two
    16-bit halves of k: no intermediate reaches 2**49."""
    return (x * (k & 0xFFFF) + (((x * (k >> 16)) & 0xFFFF) << 16)) & M32


def hash_cells(i: torch.Tensor, j: torch.Tensor, mod: int = 97,
               lo: int = 3) -> torch.Tensor:
    """Cell (i, j) of the synthetic matrix for int64 index tensors
    (broadcast), as uint8: lo + h % mod of a uint32 hash of (max, min),
    0 on the diagonal.  The uint32 wraparound is done in int64, masked
    after every step; equal to `hash_cells_np`."""
    i, j = i & M32, j & M32
    h = (_mul32(torch.maximum(i, j), HASH_K[0])
         + _mul32(torch.minimum(i, j), HASH_K[1])) & M32
    h ^= h >> 15
    h = _mul32(h, HASH_K[2])
    h ^= h >> 13
    return torch.where(i == j, 0, h % mod + lo).to(torch.uint8)


def hash_cells_np(i, j, mod: int = 97, lo: int = 3) -> np.ndarray:
    """`hash_cells` in numpy uint32 arithmetic (wraps by itself): the
    spot check's oracle."""
    i = np.asarray(i).astype(np.uint32)
    j = np.asarray(j).astype(np.uint32)
    k1, k2, k3 = (np.uint32(k) for k in HASH_K)
    with np.errstate(over="ignore"):
        h = np.maximum(i, j) * k1 + np.minimum(i, j) * k2
        h ^= h >> np.uint32(15)
        h *= k3
        h ^= h >> np.uint32(13)
    v = h % np.uint32(mod) + np.uint32(lo)
    return np.where(i == j, 0, v).astype(np.uint8)


def hash_words(n: int, dev, mod: int = 97, lo: int = 3) -> torch.Tensor:
    """The packed engine's (npad, npad/4) int32 words of the n-taxon
    hash matrix (npad = pe.pad_packed(n)), made on `dev` in groups of
    HASH_ROWS rows of its uint8 view; 0 outside [0, n)."""
    npad = pe.pad_packed(n)
    words = torch.zeros((npad, npad // 4), dtype=torch.int32, device=dev)
    D8 = words.view(torch.uint8)
    cols = torch.arange(n, device=dev)[None, :]
    for r0 in range(0, n, HASH_ROWS):
        rows = torch.arange(r0, min(r0 + HASH_ROWS, n), device=dev)
        D8[r0:r0 + rows.numel(), :n] = hash_cells(rows[:, None], cols, mod,
                                                  lo)
    return words


def spot_check(words: torch.Tensor, n: int, cells: int = SPOT_CELLS) -> int:
    """`cells` cells of the hash matrix on the card against
    `hash_cells_np`: random ones, the last rows and columns, the
    padding.  Returns the number of cells that differ."""
    npad = words.shape[0]
    rng = np.random.default_rng(SEED)
    ri, rj = rng.integers(0, npad, (2, cells))
    tail = np.arange(64)
    ri[:64], rj[64:128] = n - 1 - tail, n - 1 - tail
    ri[128:192], rj[128:192] = n - 1, n - 1 - tail
    ri[192:224], rj[192:224] = npad - 1 - tail[:32], npad - 1
    rj[224:256] = npad - 1 - tail[:32]
    got = words.view(torch.uint8)[torch.from_numpy(ri).to(words.device),
                                  torch.from_numpy(rj).to(words.device)]
    want = np.where((ri < n) & (rj < n), hash_cells_np(ri, rj), 0)
    return int((got.cpu().numpy() != want).sum())


def parity_names(n: int) -> list:
    """Taxon names T0000000 ... with the capacities the reference's
    Phylip loader gives them (32 names of capacity 4, then 32, each
    grown for its 8 characters and separator, phy.c:370-429): formNode
    orders children by capacity (nwck.c:45-50)."""
    names = []
    for i in range(n):
        nm = Name(b"", 4 if i < 32 else 32)
        nm.grow_for(9)
        nm.data = b"T%07d" % i
        names.append(nm)
    return names


def parity_newick(out, n: int, times: dict | None = None) -> bytes:
    """The Newick file of the packed engine's records `out`
    (dnj_joins_packed's tuple) at ByteScale 1, as `tree -m dnj -b`
    writes it: limbs_host, then _records_to_newick on `parity_names`,
    then ";\\n".  `times`, if given, gets the seconds of "limbs" (the
    records' copy to the host included), "names" and "newick"."""
    times = {} if times is None else times
    t = time.perf_counter()
    I, J, DIJ2, SDI2, SDJ2, d_last2 = out[:6]
    LI, LJ = pe.limbs_host(I, J, DIJ2, SDI2, SDJ2, n, 1.0)
    d_last = int(d_last2) / 2.0
    times["limbs"], t = time.perf_counter() - t, time.perf_counter()
    names = parity_names(n)
    times["names"], t = time.perf_counter() - t, time.perf_counter()
    nwk = te._records_to_newick(I, J, LI, LJ, d_last, n, names, 0, 9)
    times["newick"] = time.perf_counter() - t
    return nwk + b";\n"


def records_digest(out, n: int) -> str:
    """sha256[:16] over I, J, DIJ2, SDI2, SDJ2 [:n-2] as int32, in that
    order: the evidence's records digest."""
    h = hashlib.sha256()
    for x in out[:5]:
        a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        h.update(np.ascontiguousarray(a[:n - 2], np.int32).tobytes())
    return h.hexdigest()[:16]


def first_difference(a: bytes, b: bytes) -> int:
    """The first offset where two byte strings differ (the shorter's
    length if one is a prefix of the other)."""
    k = min(len(a), len(b))
    x = np.frombuffer(a[:k], np.uint8) != np.frombuffer(b[:k], np.uint8)
    return int(x.argmax()) if x.any() else k


def parity_run(words: torch.Tensor, n: int, card: str) -> tuple:
    """The whole tree of the packed engine on the hash matrix `words`
    (updated in place) through its entry points: dnj_joins_packed (one
    dnj_segment launch a segment), then `parity_newick`.  Asserts the run's segment flags (STAGE_Q exactly
    where Q fits in shared memory) and its launches (dnj_segment once a
    segment, no other kernel of the join loop).  Returns (Newick,
    records digest, measures)."""
    npad = words.shape[0]
    preps = []
    real = pe.dnj_segment_prepare

    def prepare(*a, **kw):
        preps.append(real(*a, **kw))
        return preps[-1]

    pe.dnj_segment_prepare = prepare
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        out, t_engine = synced(lambda: pe.dnj_joins_packed(words, n,
                                                           kbatch=KBATCH))
    finally:
        pe.dnj_segment_prepare = real
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in build.launches.items() if v}
    flags = preps[0][2]
    stage = bool(flags & segment.STAGE_Q)
    assert len(preps) == 1 and stage == (segment.smem_bytes(
        segment.STAGE_Q, npad) <= segment.MAX_DYNAMIC_SMEM), (npad, flags)
    assert launches == {"dnj_segment": -(-(n - 2) // segmenting.SEG)}, \
        launches
    passes = int(pe.dnj_joins_packed.last_stats[0])
    times = {}
    nwk = parity_newick(out, n, times)
    digest = records_digest(out, n)
    m = {"n": n, "npad": npad, "flags": flags, "stage_q": stage,
         "launches": launches, "engine_s": t_engine,
         "joins_per_s": (n - 2) / t_engine, "passes": passes,
         "passes_per_join": passes / (n - 2), "peak_bytes": peak,
         "newick_bytes": len(nwk), "sha256": hashlib.sha256(nwk).hexdigest(),
         "records_digest": digest, **{k + "_s": v for k, v in times.items()}}
    log(f"parity n={n} ({card}): engine {t_engine:.2f} s, "
        f"{m['joins_per_s']:,.1f} joins/s, {passes} passes "
        f"({m['passes_per_join']:.3f} per join; the evidence's TPU run "
        f"{EVIDENCE_PASSES} at n = 100,000), flags {flags} (STAGE_Q "
        f"{stage}), launches {launches}; limbs {times['limbs']:.2f} s, "
        f"names {times['names']:.2f} s, Newick {times['newick']:.2f} s "
        f"({len(nwk):,} bytes); peak {peak / 2 ** 30:.2f} GiB on the card; "
        f"records digest {digest}")
    return nwk, digest, m


def phase_parity(dev, res):
    """The packed engine's whole tree at n = N_PARITY_Q (Q in shared
    memory) and N_PARITY (Q read through L2) on the synthetic hash
    matrix made on the card, each Newick held to the C reference's
    (benchmarks/evidence: the bytes at N_PARITY, the sha256 at both) and
    the records to the evidence's digest; at N_PARITY first
    dnj_segment held to dnj_segment_plain at every CHECK_SEG joins of
    the first CHECKED_JOINS (every state array), `probe_segment` and
    `segment_breakdown` on the first segment.  Prints seconds of every
    step, joins/s, passes per join and the peak memory on the card,
    each with the card's name and power limit."""
    out = res["parity"] = {}
    card = card_line()
    evidence = gzip.decompress((Path(REPO) / PARITY_NWK).read_bytes())
    assert len(evidence) == PARITY_BYTES and hashlib.sha256(
        evidence).hexdigest() == PARITY_SHA256[N_PARITY], "evidence file"
    failed = []
    for n in (N_PARITY_Q, N_PARITY):
        o = out[n] = {"held_before_bytes": torch.cuda.memory_allocated()}
        words, o["generate_s"] = synced(lambda: hash_words(n, dev))
        bad = spot_check(words, n)
        assert bad == 0, f"{bad} of {SPOT_CELLS} cells differ at n={n}"
        torch.cuda.reset_peak_memory_stats()
        _, o["init_s"] = synced(lambda: pe._packed_init(words, n))
        o["init_peak_bytes"] = torch.cuda.max_memory_allocated()
        o["matrix_bytes"] = words.numel() * 4
        log(f"parity n={n} ({card}): hash matrix {words.shape[0]} rows "
            f"({o['matrix_bytes'] / 1e9:.2f} GB) made in "
            f"{o['generate_s']:.2f} s, {SPOT_CELLS} cells equal the numpy "
            f"hash; init alone {o['init_s']:.2f} s, peak "
            f"{o['init_peak_bytes'] / 2 ** 30:.2f} GiB (of which "
            f"{o['held_before_bytes'] / 2 ** 30:.2f} GiB held by earlier "
            "phases)")
        if n == N_PARITY:  # the kernel without Q, on copies of the matrix
            D8 = words.view(torch.uint8)
            h = held_to_plain(D8, n, CHECKED_JOINS, ["no Q"], o,
                              "segment_check")
            err = res.setdefault("max_abs_err", {})
            err["dnj_segment"] = max(err.get("dnj_segment", 0),
                                     h["max_abs_err"])
            probe_segment(D8, n, o, "segment_probe")
            segment_breakdown(D8, n, segmenting.SEG, ["no Q"], o,
                              "segment_breakdown")
            del D8
        nwk, digest, m = parity_run(words, n, card)
        del words
        o.update(m)
        # every size is run before a difference raises
        if m["sha256"] != PARITY_SHA256[n]:
            failed.append(f"n={n}: Newick sha256 {m['sha256']}, the C "
                          f"reference's {PARITY_SHA256[n]}")
        if n == N_PARITY and nwk != evidence:
            failed.append(f"n={n}: Newick differs from the C reference's "
                          f"at byte {first_difference(nwk, evidence)}")
        if n == N_PARITY and digest != PARITY_DIGEST:
            failed.append(f"n={n}: records digest {digest}, the "
                          f"evidence's {PARITY_DIGEST}")
        log(f"parity n={n}: Newick {len(nwk):,} bytes, sha256 "
            f"{m['sha256'][:16]}..., records digest {digest}")
    del evidence
    torch.cuda.empty_cache()
    assert not failed, failed
    log(f"parity ({card}): each Newick equals the C reference's (sha256; "
        f"at n={N_PARITY} byte for byte with {PARITY_NWK}, records digest "
        f"{PARITY_DIGEST}); n={N_PARITY} dnj_segment launches "
        f"{out[N_PARITY]['launches']['dnj_segment']}")



# ---------------------------------------------------------------------
# phase 6: the row-cache engine on a matrix held on the host


def scale_matrix(dev, g):
    """Phase 4's u8 matrix, for a run of the streamed phase alone."""
    seqs, shared_inc, _ = outbreak(dev, g, N_SCALE, L_SCALE,
                                   per_sample=False)
    pm = pack2(shared_inc[None].to(torch.uint8))[0]
    return snp_torch.snp_matrix(seqs, pm).clamp(0, 255).to(torch.uint8)


def streamed_stretch(eng, start, stop):
    """Joins [start, stop) of the row-cache engine, with what they cost:
    the engine's counters and host clocks over the stretch, and the
    seconds its first STREAM_MORE joins took."""
    before = dict(eng.times, rows=eng.uploaded_rows, misses=eng.aborts)
    marks = {}

    def mark(st, done, total):
        marks[done - start] = time.perf_counter()

    t0 = time.perf_counter()
    out, t = synced(lambda: eng.run(start=start, stop=stop, hooks=mark))
    d = {k: eng.times[k] - before[k] for k in eng.times}
    joins = stop - start
    # (segments end every segmenting.SEG joins: a multiple of it)
    d["first_joins_per_s"] = STREAM_MORE / (marks[STREAM_MORE] - t0) \
        if STREAM_MORE in marks else joins / t
    d.update(joins=joins, s=t, joins_per_s=joins / t,
             misses=eng.aborts - before["misses"],
             rows_uploaded=eng.uploaded_rows - before["rows"])
    d["bytes_uploaded"] = d["rows_uploaded"] * eng.n
    # shares of the stretch, by the host's clock: uploads, the replay
    # of the host matrix, and the rest, driving the card's joins
    d["upload_share"] = d["upload_s"] / t
    d["replay_share"] = d["replay_s"] / t
    d["device_work_share"] = (t - d["upload_s"] - d["replay_s"]) / t
    log(f"streamed n={eng.n} X={eng.X} joins {start}..{stop}: {t:.2f} s, "
        f"{d['joins_per_s']:,.1f} joins/s; {d['misses']} misses, "
        f"{d['rows_uploaded']} rows = {d['bytes_uploaded'] / 2 ** 20:.1f} "
        f"MiB uploaded; uploads {d['upload_share']:.1%} of the time, host replay "
        f"{d['replay_share']:.1%} ({1e3 * d['replay_s'] / joins:.3f} ms "
        f"per join), driving the card {d['device_work_share']:.1%}")
    return out, d


def phase_streamed(dev, g, res, D8=None):
    out = res["streamed"] = {}
    if D8 is None:  # run alone: phase 4's model, its own seed
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 2)
        D8 = scale_matrix(dev, g)
    n, X, joins = N_SCALE, X_SCALE, STREAM_JOINS
    Dq = D8.cpu().numpy()

    # the packed engine's first joins on the same matrix, timed
    prefix, t_packed = synced(lambda: first_joins(D8, n, joins))
    out["packed_joins_per_s"] = joins / t_packed
    log(f"packed engine n={n}, first {joins} joins: {t_packed:.2f} s, "
        f"{joins / t_packed:,.1f} joins/s")

    eng = se.StreamedDNJ(Dq, n, X=X, kbatch=KBATCH, device=dev)
    build.reset_launches()
    recs, out["first"] = streamed_stretch(eng, 0, joins)
    log(f"first {STREAM_MORE} joins at n={n}: row-cache engine "
        f"{out['first']['first_joins_per_s']:,.1f} joins/s")
    res["streamed_launches"] = dict(build.launches)
    assert build.launches["qrow_mins_slots"] > 0 \
        and build.launches["qrow_mins"] == 0
    for name, ours in zip(("I", "J", "DIJ2", "SDI2", "SDJ2"), recs):
        np.testing.assert_array_equal(ours[:joins],
                                      prefix[name][:joins].cpu().numpy(),
                                      err_msg=name)
    del prefix
    out["first"]["passes"] = int(eng.stats[0])
    out["first"]["qrow_mins_slots_launches"] = \
        build.launches["qrow_mins_slots"]
    log(f"streamed records of the first {joins} joins equal the packed "
        f"engine's; {int(eng.stats[0])} passes, "
        f"{build.launches['qrow_mins_slots']} qrow_mins launches through "
        f"slots; cache {X * n / 2 ** 20:.0f} MiB of a "
        f"{n * n / 2 ** 20:.0f} MiB matrix")
    del eng, Dq

    # a whole run: every record and the final matrix
    n, X = N_STREAM, X_STREAM
    D8s = D8[:n, :n].contiguous()
    words = D8s.clone().view(torch.int32)
    ref, t_packed = synced(lambda: pe.dnj_joins_packed(words, n,
                                                       kbatch=KBATCH))
    Dq = D8s.cpu().numpy()
    eng = se.StreamedDNJ(Dq, n, X=X, kbatch=KBATCH, device=dev)
    recs, out["whole"] = streamed_stretch(eng, 0, n - 2)
    for name, ours, theirs in zip(("I", "J", "DIJ2", "SDI2", "SDJ2"),
                                  recs, ref):
        np.testing.assert_array_equal(ours[:n - 2],
                                      theirs.cpu().numpy()[:n - 2],
                                      err_msg=name)
    assert recs[5] == int(ref[5])
    np.testing.assert_array_equal(
        Dq, ref[6].view(torch.uint8).cpu().numpy())
    out["whole"]["packed_joins_per_s"] = (n - 2) / t_packed
    log(f"whole run n={n} X={X}: records and final matrix equal the "
        f"packed engine's ({t_packed:.2f} s, {(n - 2) / t_packed:,.1f} "
        f"joins/s)")


# ---------------------------------------------------------------------
# phase 7: count-matrix distances


def count_matrices(dev, g, k, L):
    """k count matrices (L_i, 6) uint16 with their totals, on the host:
    one random reference; each sample differs from it at ~0.1% of the
    positions, has depth Poisson(40) (Poisson(3) at a tenth of the
    positions), ~1% of a position's reads on another base, a few gap
    and N reads; the last three samples are shorter."""
    ref = torch.randint(0, 4, (L,), device=dev, generator=g)
    pos = torch.arange(L, device=dev)
    counts, totals = [], []
    for i in range(k):
        u = torch.rand((3, L), device=dev, generator=g)
        shift = torch.randint(1, 4, (2, L), device=dev, generator=g)
        base = torch.where(u[0] < 0.001, (ref + shift[0]) % 4, ref)
        lam = torch.where(u[1] < 0.1, 3.0, 40.0)
        depth = torch.poisson(lam, generator=g)
        wrong = torch.minimum(torch.poisson(depth * 0.01, generator=g),
                              depth)
        c = torch.zeros((L, 6), dtype=torch.int32, device=dev)
        c[pos, base] = (depth - wrong).int()
        c[pos, (base + shift[1]) % 4] += wrong.int()
        c[:, 4] = torch.poisson(torch.full((L,), 0.05, device=dev),
                                generator=g).int()
        c[:, 5] = torch.poisson(torch.full((L,), 0.1, device=dev),
                                generator=g).int()
        Li = L - (1 + i - (k - 3)) * (L // 200) if i >= k - 3 else L
        c = c[:Li]
        counts.append(c.cpu().numpy().astype(np.uint16))
        totals.append(c.sum(dim=1).cpu().numpy().astype(np.int64))
    return counts, totals


def host_pairs(method, counts, totals, pairs):
    """cmp_mats of the port's host metrics on `pairs`: (sum, rows_inc),
    no norm and no length gate."""
    veccmp = get_veccmp(method, 0.05)
    return [cmp_mats(counts[i], totals[i], counts[j], totals[j], 0,
                     MAT_MIN_DEPTH, 1, 0.0, veccmp) for i, j in pairs]


def held_to_host(method, S, R, host, pairs):
    """rows_inc equal on every pair; returns the largest relative error
    of the sums, whether all are bit-equal, and the positions by which
    rows_inc differs.  Only nl<n> may differ there: where two channels
    differ, its base (d0^n + |d1|^n with d0 = -|d1| up to rounding) is
    rounding noise around 0 in the reference too, and a negative base is
    excluded."""
    rel, same, gate = 0.0, True, 0
    noisy = method.startswith("nl") and method not in matdist_torch.METRICS
    for (i, j), (dist, rinc) in zip(pairs, host):
        if dist == -1.0:  # nothing scored: rows_inc 0
            rinc = 0
        gate += abs(int(R[i, j]) - rinc)
        assert noisy or int(R[i, j]) == rinc, (method, i, j, int(R[i, j]),
                                               rinc)
        if dist == -1.0:
            continue
        same &= float(S[i, j]) == dist
        rel = max(rel, abs(float(S[i, j]) - dist) / max(abs(dist), 1e-300))
    return rel, same, gate


def z_gates_equal(q, dev) -> bool:
    """Whether p_chisqr(q) <= alpha on the card equals the host's for
    every q, at the three alphas."""
    ph = p_chisqr(q)
    pc = matdist_torch._p_chisqr(torch.from_numpy(q).to(dev)).cpu().numpy()
    return all(bool(((pc <= a) == (ph <= a)).all()) for a in Z_CRITICAL)


def z_gate_on_card(dev, tmax=4096, tdeep=Z_DEPTH, window=8):
    """Whether z's gate p_chisqr(q) <= alpha, q = (t - 2 mx)^2 / t, on
    the card equals the host's at three alphas: for every column of
    total t <= tmax and majority count mx <= t; then, the gate being
    monotone in q on each side of mx = t/2, for every total t <= tdeep
    on the counts within `window` of each crossing.  Returns (equal,
    columns compared)."""
    t = np.arange(1, tmax + 1, dtype=np.float64)
    equal, count = True, 0
    for t0 in range(0, tmax, 512):
        T, M = np.meshgrid(t[t0:t0 + 512], np.arange(0, tmax + 1.0),
                           indexing="ij")
        keep = M <= T
        equal &= z_gates_equal((T[keep] - 2 * M[keep]) ** 2 / T[keep], dev)
        count += int(keep.sum())
    t = np.arange(1, tdeep + 1, dtype=np.float64)[:, None]
    off = np.arange(-window, window + 1)
    for qc in Z_CRITICAL.values():
        low = np.floor((t - np.sqrt(qc * t)) / 2)  # the lower crossing
        M = np.concatenate([low + off, t - low + off], axis=1)
        T = np.broadcast_to(t, M.shape)
        keep = (M >= 0) & (M <= T)
        equal &= z_gates_equal((T[keep] - 2 * M[keep]) ** 2 / T[keep], dev)
        count += int(keep.sum())
    return equal, count


def phase_matdist(dev, res):
    out = res["matdist"] = {}
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    k, L = K_MAT, L_MAT
    (counts, totals), t = synced(lambda: count_matrices(dev, g, k, L))
    lens = [len(c) for c in counts]
    log(f"count matrices k={k} L={L}: made in {t:.1f} s, "
        f"{sum(c.nbytes for c in counts) / 2 ** 30:.2f} GiB on the host, "
        f"lengths {min(lens)}..{max(lens)}")
    rng = np.random.RandomState(SEED % 2 ** 31)
    # sample 1 of a pair must not be the shorter one; two pairs have a
    # shorter sample 2
    pairs = [(k - 4, k - 1), (k - 5, k - 2)]
    while len(pairs) < MAT_PAIRS:
        i, j = sorted(rng.randint(0, k - 3, 2).tolist(), reverse=True)
        if i != j and (i, j) not in pairs:
            pairs.append((i, j))
    npairs = k * (k - 1) // 2

    def table(method, cs, ts, dtype):
        spec = matdist_torch.resolve_metric(method, 0.05)
        (S, R), t = synced(lambda: matdist_torch.pair_table(
            spec, cs, ts, MAT_MIN_DEPTH, device=dev, dtype=dtype,
            lower=True))
        last = matdist_torch.pair_table.last
        share = (f"packing chunks on the host "
                 f"{last['pack_s'] / last['s']:.1%} of it, the copy calls "
                 f"(they wait for the card's last chunk) "
                 f"{last['copy_s'] / last['s']:.1%}")
        return S, R, t, share, last

    # pairs (i, j) with i > j read the strict lower triangle; put the
    # shorter samples first so that they are sample 2 there
    order = list(range(k - 3, k)) + list(range(k - 3))
    pos_of = {s: a for a, s in enumerate(order)}
    counts_o = [counts[s] for s in order]
    totals_o = [totals[s] for s in order]
    pairs_o = [(pos_of[i], pos_of[j]) for i, j in pairs]
    assert all(i > j and len(counts_o[j]) <= len(counts_o[i])
               for i, j in pairs_o)

    host = host_pairs("cos", counts_o, totals_o, pairs_o)
    for name, dtype, tol in (("float64", torch.float64, 1e-10),
                             ("float32", torch.float32, 2e-5)):
        S, R, t, share, last = table("cos", counts_o, totals_o, dtype)
        rel, same, _ = held_to_host("cos", S, R, host, pairs_o)
        assert rel <= tol, (name, rel)
        out["cos_" + name] = {
            "s": t, "pair_positions_per_s": npairs * L / t,
            "pack_share": last["pack_s"] / last["s"],
            "copy_call_share": last["copy_s"] / last["s"],
            "max_rel_err": rel,
            "block_rows": last["block_rows"], "chunks": last["chunks"]}
        log(f"matdist -d cos {name} k={k} L={L}: {t:.2f} s, "
            f"{npairs * L / t:,.0f} pair-positions/s, {share} "
            f"({last['chunks']} chunks, "
            f"{last['block_rows']} sample rows a block); rows_inc equal "
            f"on {len(pairs)} pairs, largest relative error of a sum "
            f"against the host's {rel:.3e}")

    Ls = L_MAT_SMALL
    cs = [c[:Ls - (L - len(c)) // 10] for c in counts_o]
    ts = [t[:len(c)] for t, c in zip(totals_o, cs)]
    methods = [m for m in sorted(matdist_torch.METRICS) if m != "cos"] \
        + ["z", "l3", "nl3", "l4"]
    exact = []
    for method in methods:
        S, R, t, share, last = table(method, cs, ts, torch.float64)
        rel, same, gate = held_to_host(method, S, R,
                                       host_pairs(method, cs, ts, pairs_o),
                                       pairs_o)
        if method in matdist_torch.EXACT_METRICS:
            assert same, f"-d {method}: sums differ from the host's"
        # a position more or less of nl<n> adds the n-th root of noise
        assert rel <= (1e-9 if gate == 0 else 1e-3), (method, rel)
        if same:
            exact.append(method)
        out[method] = {"s": t, "pair_positions_per_s": npairs * Ls / t,
                       "pack_share": last["pack_s"] / last["s"],
                       "copy_call_share": last["copy_s"] / last["s"],
                       "max_rel_err": rel,
                       "bit_equal": same, "rows_inc_differs_by": gate}
        log(f"matdist -d {method} float64 k={k} L={Ls}: {t:.2f} s, "
            f"{npairs * Ls / t:,.0f} pair-positions/s, {share}; rows_inc "
            f"{'equal' if gate == 0 else f'differs by {gate} positions'}, "
            f"largest relative error {rel:.3e}"
            f"{', sums bit-equal to the host' if same else ''}")
    out["bit_equal_on_card"] = exact
    equal, cols = z_gate_on_card(dev)
    out["z_gate_equal_to_depth_65535"] = equal
    out["z_gate_columns"] = cols
    log(f"bit-equal to the host on {len(pairs)} pairs on the card: {exact}; "
        f"z's gate equals the host's on every column up to depth 4096 and "
        f"around each alpha's crossing up to depth {Z_DEPTH} ({cols} "
        f"columns, 3 alphas): {equal}")
    assert equal, "z's gate differs from the host's"

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


def taxa(flat) -> int:
    """The taxa of a loaded ltd matrix of len(flat) cells."""
    n = int((1 + math.isqrt(8 * len(flat) + 1)) // 2)
    assert n * (n - 1) // 2 == len(flat), len(flat)
    return n


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


def caterpillar_flat(dev, g, n):
    """A loaded ltd matrix that joins along a chain: D_ij = |i - j| plus
    integer noise in [0, 2].  Each join stores (D_ik + D_kj - D_ij) / 2
    into the lineage the next join takes up again, so the fractional
    bits of the cells pile up with the depth of the tree."""
    i, j = np.tril_indices(n, -1)
    noise = torch.randint(0, 3, (len(i),), device=dev, generator=g)
    return (i - j + noise.cpu().numpy()).astype(np.float64)


def assert_tree_shape(nwk, I, J, n):
    """n-2 joins with j < i inside the active taxa, and a Newick with n
    leaves."""
    m_t = n - np.arange(n - 2)
    assert len(I) == n - 2 and ((J >= 0) & (J < I) & (I < m_t)).all()
    assert nwk.count(b"iso") == n and nwk.count(b",") == n - 1
    assert nwk.count(b"(") == nwk.count(b")")


class _HandedOff(Exception):
    pass


def _stop_at_host(*args, **kw):
    raise _HandedOff


def dispatch(flat, n, method, dtype, engine=None, bytescale=1.0,
             handoff=True):
    """tree_cmd._dispatch_build at the CLI defaults under
    CCPHYLO_TORCH_ENGINE=engine (None: unset); returns (Newick, seconds,
    the engine that ran).  handoff=False: a device run that the
    dispatcher hands to the host engine (its row sums left the exact
    range) stops there, (None, seconds, "exact"); its note is on
    stderr."""
    os.environ.pop("CCPHYLO_TORCH_ENGINE", None)
    if engine:
        os.environ["CCPHYLO_TORCH_ENGINE"] = engine
    host = tree_cmd.build_tree
    if not handoff:
        tree_cmd.build_tree = _stop_at_host
    try:
        nwk, t = synced(lambda: tree_cmd._dispatch_build(
            flat, n, iso_names(n), method, 0, 9, dtype, bytescale))
    except _HandedOff:
        nwk, t = None, 0.0
    finally:
        os.environ.pop("CCPHYLO_TORCH_ENGINE", None)
        tree_cmd.build_tree = host
    return nwk, t, tree_cmd._dispatch_build.last_engine


def card_route(flat, n, method, dtype, want, handed, key):
    """The default route on the card: the engine `want`, or, where its
    row sums leave float64's exact range, the host engine (its note in
    handed[key]; the card's rate is then taken under device64, whose
    bytes are not promised).  Returns the `runs` entry (matrix, method,
    dtype, Newick, seconds, engine)."""
    note = io.StringIO()
    with contextlib.redirect_stderr(note):
        nwk, t, ran = dispatch(flat, n, method, dtype, handoff=False)
    if ran == "exact":
        assert "exact range" in note.getvalue(), note.getvalue()
        handed[key] = note.getvalue().strip()
        nwk, t, ran = dispatch(flat, n, method, dtype, "device64")
    assert ran == want, (method, dtype, ran)
    return flat, method, dtype, nwk, t, ran


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


def exact_range(flat, n, dev, every=64, method="dnj"):
    """The float64 engine of `method` (dnj or upgma) on the card, stopped
    every `every` joins to read how far its state is from the end of
    float64's exact range: the fractional bits of the cells, the bits a
    row sum needs (integer bits of the largest sum plus those fractional
    bits), and whether every sD equals the sum of its row taken in
    64-bit-mantissa long doubles on the host (it does while the sums are
    exact).  Complete matrices only.  Returns (the engine's final state,
    statistics); run_s is the seconds of its joins alone."""
    D = torch.from_numpy(te.square_matrix(flat, n)).to(dev)
    if method == "dnj":  # one dnj_segment_float launch a stretch
        st, seg = te._new_state(D, n), te._run_segment
    else:
        st, seg = he._new_state(D, n, method)
        seg = functools.partial(seg, method=method)
    out = {"fraction_bits": 0, "sum_bits": 0, "inexact_sums": 0,
           "states_read": 0, "run_s": 0.0}
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
        out["run_s"] += synced(lambda: seg(st, t0, min(t0 + every, n - 2),
                                           n))[1]
    return st, out


def plain_stop(flat, n, dev) -> int:
    """The join at which dnj_segment_float_plain, with the exact range
    tracked, stops on the card (-1: none)."""
    st = float_state(torch.from_numpy(te.square_matrix(flat, n)).to(dev), n,
                     exact=True)
    for t0 in range(0, n - 2, CHECK_SEG):
        segment_float.dnj_segment_float_plain(
            *float_args(st), t0, min(t0 + CHECK_SEG, n - 2), n)
        if int(st["first_inexact"]) >= 0:
            break
    return int(st["first_inexact"])


def float_turns(flat, n, nwk, res):
    """tree -m dnj on float64 at n through tree_cmd._dispatch_build on the
    default route, its segments run by the kernel (one dnj_segment_float
    launch a segment) and by the plain loop, in turns: kernel, plain,
    plain, kernel.  For each: joins/s, the launches of the port's
    kernels, and the calls that wait for the card (host reads and
    fences, as torch.cuda.set_sync_debug_mode("warn") reports them) per
    join; every Newick equal to the default route's `nwk`.  The first
    run's launches are the `kernels` line's.  Then joins 64..128 of
    each loop under torch.profiler: kernel launches and device-to-host
    copies per join."""
    from torch.profiler import ProfilerActivity, profile
    real = segment_float.dnj_segment_float

    def plain(*a, prep=None):
        return segment_float.dnj_segment_float_plain(*a)

    runs = res["float_turns"] = []
    for kind in ("kernel", "plain", "plain", "kernel"):
        segment_float.dnj_segment_float = real if kind == "kernel" else plain
        build.reset_launches()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out, t, ran = dispatch(flat, n, "dnj", "d")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        finally:
            segment_float.dnj_segment_float = real
        launches = {k: v for k, v in build.launches.items() if v}
        if "float_path_launches" not in res:
            res["float_path_launches"] = dict(build.launches)
        waits = sum("synchroniz" in str(w.message) for w in caught)
        assert ran == "float64" and out == nwk, (kind, ran)
        assert launches == ({"dnj_segment_float": -(-(n - 2)
                                                    // segmenting.SEG)}
                            if kind == "kernel" else {}), launches
        assert kind == "kernel" or waits > n - 2, waits
        runs.append({"loop": kind, "s": t, "joins_per_s": (n - 2) / t,
                     "launches": launches,
                     "launches_per_join": sum(launches.values()) / (n - 2),
                     "waits_per_join": waits / (n - 2)})
    log(f"tree n={n} -m dnj float64 through _dispatch_build, in turns: "
        + "; ".join(f"{r['loop']} {r['joins_per_s']:,.1f} joins/s, "
                    f"{r['launches_per_join']:.5f} port launches and "
                    f"{r['waits_per_join']:.3f} waits for the card a join"
                    for r in runs))
    # one profiler session for both loops, the windows told apart by a
    # spin between them
    D0 = torch.from_numpy(te.square_matrix(flat, n)).to("cuda")
    loops = (("kernel", te._run_segment), ("plain", te._dnj_segment))
    sts = {kind: te._new_state(D0.clone(), n) for kind, _ in loops}
    for kind, seg in loops:
        seg(sts[kind], 0, PROFILE_JOINS, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x, (kind, seg) in enumerate(loops):
            if x:
                torch.cuda._sleep(SEG_SPIN)
            seg(sts[kind], PROFILE_JOINS, 2 * PROFILE_JOINS, n)
            torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    cut = min(e.time_range.start for e in ev if "spin" in e.name.lower())
    window = res["float_profile"] = {}
    for kind, part in (("kernel", [e for e in ev
                                   if e.time_range.start < cut]),
                       ("plain", [e for e in ev if e.time_range.start > cut
                                  and "spin" not in e.name.lower()])):
        kernels = [e for e in part if "Memcpy" not in e.name
                   and "Memset" not in e.name]
        reads = [e for e in part if "Memcpy DtoH" in e.name]
        assert kernels and reads, (kind, "the profiler saw no activity")
        window[kind] = {
            "launches_per_join": len(kernels) / PROFILE_JOINS,
            "host_reads_per_join": len(reads) / PROFILE_JOINS,
            "device_ms_per_join": sum(e.time_range.elapsed_us()
                                      for e in kernels) / 1e3
            / PROFILE_JOINS}
    del sts
    log(f"joins {PROFILE_JOINS}..{2 * PROFILE_JOINS} at n={n} under "
        "torch.profiler: " + "; ".join(
            f"{k} {v['launches_per_join']:.3f} launches, "
            f"{v['host_reads_per_join']:.3f} host reads, "
            f"{v['device_ms_per_join']:.4f} ms of kernels a join"
            for k, v in window.items()))


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

    # the host runs that take a minute or more start first and work
    # beside the card's runs (three busy cores of the host's): the run
    # at depth, and nj and mn on the main path's matrix; all other host
    # runs wait for the card's timed runs
    nd = N_DEPTH
    dflat = snp_flat(dev, g, nd, L_SCALE)
    f_depth = pool.submit(host_tree, dflat, nd, "dnj")
    early = {m: pool.submit(host_tree, flat, n, m, "d") for m in ("nj", "mn")}

    # every method on the default route; then dnj on u16 cells (-s, the
    # default route) and on u8 cells (device64 -b)
    te.dnj_joins(torch.zeros((64, 64), dtype=torch.float64, device=dev),
                 64)  # warm-up outside the timed runs
    handed = out["handed_to_host"] = {}
    for method in TREE_METHODS:
        want = "float64" if method == "dnj" else "hclust/float64"
        runs[method] = card_route(flat, n, method, "d", want, handed, method)
    float_turns(flat, n, runs["dnj"][3], res)
    runs["dnj -s"] = card_route(flat, n, "dnj", "s", "u16/float64", handed,
                                "dnj -s")
    nwk, t, ran = dispatch(flat, n, "dnj", "b", "device64")
    assert ran == "u8/float64", ran
    runs["dnj -b"] = (flat, "dnj", "b", nwk, t, ran)

    # the default route on a matrix that is not additive: random
    # integers in [0, 25), the methods whose host run takes seconds; the
    # hclust engines on its first N_RANDOM taxa (a prefix of the flat
    # lower triangle)
    rflat = random_flat(dev, g, n, 0, 25)
    for method in RANDOM_METHODS:
        want = "float64" if method == "dnj" else "hclust/float64"
        key = method + ", random cells"
        nr = n if method == "dnj" else N_RANDOM
        runs[key] = card_route(rflat[:nr * (nr - 1) // 2], nr, method, "d",
                               want, handed, key)

    # dnj on float32 state (the route of `device`): shape only;
    # agreement with float64 printed
    os.environ["CCPHYLO_TORCH_ENGINE"] = "device"
    try:
        ran32 = tree_cmd._engine_name(*tree_cmd._route(flat, "dnj", "d",
                                                       1.0)[:3])
    finally:
        del os.environ["CCPHYLO_TORCH_ENGINE"]
    assert ran32 == "float32", ran32
    D32 = torch.from_numpy(te.square_matrix(flat, n)).to(dev, torch.float32)
    rec32, t32 = synced(lambda: te.dnj_joins(D32, n))
    del D32
    I32, J32 = (a[:joins] for a in rec32[:2])
    nwk32 = te._records_to_newick(*rec32[:5], n, iso_names(n), 0, 9)
    assert_tree_shape(nwk32, I32, J32, n)
    held_float(torch.from_numpy(te.square_matrix(flat, n)).to(
        dev, torch.float32), n, joins, res,
        f"segment_float_check_{n}_float32", exact=True)
    # the candidate-list design at this size (the default takes the first
    # design here): held to the plain loop on the first CHECKED_JOINS
    # joins (its list overflows: top-ups from the copy of Q, asserted),
    # and timed in turns against the first design
    D64 = torch.from_numpy(te.square_matrix(flat, n)).to(dev)
    x = held_float(D64.clone(), n, CHECKED_JOINS, res,
                   f"segment_float_check_{n}_list", flags=list_flags(n))
    assert x["refills"] > 0, x
    float_breakdown(D64, n, segmenting.SEG, float_turns_of(n), res,
                    f"float_breakdown_{n}")
    del D64

    # a non-integer copy of the first N_RANDOM taxa: the default route is
    # the host, with its note; device64 -m upgma runs on the card
    noise = torch.rand(flat.shape[0], dtype=torch.float64, device=dev,
                       generator=g).cpu().numpy()
    nr = N_RANDOM
    fflat = (flat + 0.5 * noise)[:nr * (nr - 1) // 2]
    note = io.StringIO()
    with contextlib.redirect_stderr(note):
        nwk_host, t_host, ran = dispatch(fflat, nr, "upgma", "d")
    assert ran == "exact", ran
    assert note.getvalue().count("\n") == 1 \
        and "CCPHYLO_TORCH_ENGINE=device64" in note.getvalue()
    nwk, t, ran = dispatch(fflat, nr, "upgma", "d", "device64")
    assert ran == "hclust/float64", ran
    assert nwk.count(b"iso") == nr and nwk.count(b",") == nr - 1
    out["upgma_non_integer"] = {
        "n": nr, "engine": ran, "s": t, "joins_per_s": (nr - 2) / t,
        "host_exact_s": t_host, "equals_host": nwk == nwk_host}
    log(f"non-integer matrix n={nr}, -m upgma: default route [exact] "
        f"{t_host:.1f} s with its note; device64 [{ran}] {t:.3f} s, "
        f"{(nr - 2) / t:,.1f} joins/s, Newick equals the host engine's: "
        f"{nwk == nwk_host}")

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
    futures = {key: early.get(key) or pool.submit(host_tree, fl, taxa(fl),
                                                  method, dtype)
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
    # the kernel's instance with missing cells against the plain loop on
    # the first segment of the run: no sum is exact, so picks equal and
    # floats within 1e-12 of max(|x|, 1)
    Dm = torch.from_numpy(te.square_matrix(mflat, n)).to(dev)
    held_float(Dm.clone(), n, segmenting.SEG, res,
               f"segment_float_check_missing_{n}", rtol=1e-12)
    held_float(Dm.clone(), n, CHECKED_JOINS, res,
               f"segment_float_check_missing_{n}_list", rtol=1e-12,
               flags=list_flags(n))
    float_breakdown(Dm, n, segmenting.SEG, float_turns_of(n), res,
                    f"float_breakdown_missing_{n}")
    del Dm

    # how much of float64's exact range the float64 runs above used
    st64, out["exact_range_snp"] = exact_range(flat, n, dev, every=128)
    I64, J64 = (st64[k][:joins].cpu().numpy() for k in ("I", "J"))
    out["exact_range_random"] = exact_range(rflat, n, dev, every=128)[1]
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

    # a caterpillar: the bits its float64 runs use, and the default
    # route, which hands a run whose row sums leave float64's exact range
    # to the host exact engine with a note
    nc = N_CATERPILLAR
    cflat = caterpillar_flat(dev, g, nc)
    f_cat = pool.submit(host_tree, cflat, nc, "upgma")
    on_card = {}
    for method in ("dnj", "upgma"):
        s = exact_range(cflat, nc, dev, every=128, method=method)[1]
        out["exact_range_caterpillar_" + method] = s
        note = io.StringIO()
        with contextlib.redirect_stderr(note):  # the host's run not made
            nwk, t, ran = dispatch(cflat, nc, method, "d", handoff=False)
        to_host = ran == "exact"
        s.update(default_route=ran, s=t, note=note.getvalue().strip())
        assert to_host == ("exact range" in note.getvalue()), (method, s)
        if method == "dnj":  # the join the plain loop stops at, tracked
            s["plain_loop_stops_at_join"] = plain_stop(cflat, nc, dev)
            assert to_host and f"before join {s['plain_loop_stops_at_join']}" \
                in s["note"], s
        # the tracking must see what the sampled states show
        assert to_host or not (s["inexact_sums"] or s["sum_bits"] > 53), s
        if not to_host:
            on_card[method] = nwk
        log(f"caterpillar n={nc} -m {method} float64: cells reach "
            f"{s['fraction_bits']} fractional bits, a row sum needs up to "
            f"{s['sum_bits']} bits, {s['inexact_sums']} sums of "
            f"{s['states_read']} states read are not exact; default route "
            f"[{ran}] {t:.1f} s"
            + (f", note: {s['note']}" if to_host else ""))

    hosts = {key: f.result() for key, f in futures.items()}
    host_miss = {m: f.result() for m, f in f_miss.items()}
    host, t_host = f_cat.result()
    if "upgma" in on_card:
        assert on_card["upgma"] == host, "caterpillar -m upgma: Newick " \
            "differs from the host exact engine"
        log(f"caterpillar -m upgma on the card equals the host exact engine "
            f"({t_host:.1f} s in a worker process)")
    host_depth, t_host_depth = f_depth.result()
    for key, (fl, method, dtype, nwk, t, ran) in runs.items():
        host, t_host = hosts[key]
        nk = taxa(fl)
        # a run handed to the host on the default route was timed under
        # device64: its bytes are shown, not promised
        away = handed.get(key)
        assert away or nwk == host, f"-m {key}: Newick differs from the " \
                                    "host exact engine"
        out[key] = {"n": nk, "engine": ran, "s": t,
                    "joins_per_s": (nk - 2) / t, "host_exact_s": t_host,
                    "equals_host": nwk == host,
                    "default_route": "exact" if away else ran}
        log(f"tree n={nk} -m {key} [{ran}]: {t:.3f} s, {(nk - 2) / t:,.1f} "
            f"joins/s; Newick ({len(nwk)} bytes) equals the host exact "
            f"engine ({t_host:.1f} s in a worker process): {nwk == host}"
            + (f"; the default route hands it to the host: {away}"
               if away else ""))
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


# ---------------------------------------------------------------------
# phase 8: parallel/ and sharded_snp_matrix through NCCL


def cpu_join_records(D, n, method):
    """sharded_join_records in float64 on CPU tensors, in a worker
    process: its own gloo group of one rank."""
    os.environ["CCPHYLO_TORCH_DEVICE"] = "cpu"
    torch.set_num_threads(2)
    return snj.sharded_join_records(D, n, method, torch.float64)


def sum_diff(ours, theirs) -> float:
    """The largest |a - b| / max(|b|, 1) over paired float outputs."""
    return max(float(np.max(np.abs(np.asarray(a, np.float64)
                                   - np.asarray(b, np.float64))
                            / np.maximum(np.abs(np.asarray(b)), 1.0),
                            initial=0.0)) for a, b in zip(ours, theirs))


def phase_sharded(dev, res, flat=None):
    """The sharded engines at world size 1 through a real NCCL group on
    the card (one card: no second rank).  sharded_snp_matrix against
    snp_matrix at the main path's size, its snp_expand_shared launches
    counted; sharded DNJ in float64 at n = N_SHARDED beside the float64
    engine on the same matrix, records bit-equal, joins/s, passes, host
    reads and collectives per join; nj and upgma at n = 2048 against the
    same function on CPU tensors in worker processes."""
    for k in [k for k in os.environ if k.startswith("CCPHYLO_TORCH_")]:
        del os.environ[k]  # the defaults: the card
    out = res["sharded"] = {}
    rank, world = multihost.row_axis()
    backend = torch.distributed.get_backend()
    assert (rank, world, backend) == (0, 1, "nccl"), (rank, world, backend)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    if flat is None:  # run alone: the main path's model, its own seed
        flat = snp_flat(dev, g, N_DIST, L_DIST)
    n = N_DIST
    Dn = te.square_matrix(flat, n, 0.0)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(2, mp_context=ctx) as pool:
        cpu = {m: pool.submit(cpu_join_records, Dn, n, m)
               for m in ("nj", "upgma")}

        # the SNP Gram at the main path's size: sample rows over ranks
        seqs, shared_inc, _ = outbreak(dev, g, N_DIST, L_DIST,
                                       per_sample=False)
        pm = pack2(shared_inc[None].to(torch.uint8))[0]
        single, t_single = synced(lambda: snp_torch.snp_matrix(seqs, pm))
        snp_torch.sharded_snp_matrix(seqs[:256], pm)  # warm-up
        build.reset_launches()
        D, t_sh = synced(lambda: snp_torch.sharded_snp_matrix(seqs, pm))
        res["sharded_launches"] = dict(build.launches)
        assert build.launches["snp_expand_shared"] > 0
        assert torch.equal(D, single), "sharded_snp_matrix differs"
        pairs = n * (n - 1) / 2
        out["snp"] = {"n": n, "L": L_DIST, "s": t_sh, "snp_matrix_s": t_single,
                      "snp_expand_shared_launches":
                          build.launches["snp_expand_shared"]}
        log(f"sharded_snp_matrix n={n} L={L_DIST} world 1 (NCCL): "
            f"{t_sh:.3f} s = {pairs / t_sh:,.0f} sample-pairs/s, "
            f"{build.launches['snp_expand_shared']} snp_expand_shared "
            f"launches; bit-equal to snp_matrix ({t_single:.3f} s)")
        del seqs, D, single

        # sharded DNJ against the float64 engine on an SNP matrix; the
        # float64 run reads its bits in use every 1024 joins
        nd = N_SHARDED
        dflat = snp_flat(dev, g, nd, L_SCALE)
        Dd = te.square_matrix(dflat, nd)
        recs, t_sh = synced(lambda: sd.sharded_dnj_records(Dd, nd,
                                                           torch.float64))
        stats = sd.sharded_dnj_records.last
        st, rng = exact_range(dflat, nd, dev, every=2048)
        t_f64 = rng["run_s"]
        T = nd - 2
        ref = [*(st[k].cpu().numpy() for k in ("I", "J", "LI", "LJ")),
               float(st["D"][1, 0])]
        for name, a, b in zip(("I", "J"), recs, ref):
            np.testing.assert_array_equal(a[:T], b[:T], err_msg=name)
        # limbs and the last distance: this matrix leaves float64's exact
        # range late in the run (the states read show the bits), and
        # beyond it a sum on the card depends on its order (CUDA's
        # cumsum is parallel, the two engines' vectors are not as long):
        # within 1e-12
        rel = sum_diff([recs[2][:T], recs[3][:T], recs[4]],
                       [ref[2][:T], ref[3][:T], ref[4]])
        assert rel <= 1e-12, (rel, rng)
        out["dnj"] = dict(stats, n=nd, s=t_sh, joins_per_s=T / t_sh,
                          float64_engine_s=t_f64,
                          float64_engine_joins_per_s=T / t_f64,
                          limbs_max_rel_diff=rel, exact_range=rng)
        log(f"sharded DNJ n={nd} float64 world 1 (NCCL): {t_sh:.1f} s, "
            f"{T / t_sh:,.1f} joins/s, {stats['passes'] / T:.3f} passes, "
            f"{stats['host_reads'] / T:.3f} host reads and "
            f"{stats['collectives'] / T:.3f} collectives per join; the "
            f"float64 engine {t_f64:.1f} s, {T / t_f64:,.1f} joins/s: picks "
            f"bit-equal, limbs and last distance within {rel:.3e}; "
            f"its cells reach {rng['fraction_bits']} fractional bits, a row "
            f"sum {rng['sum_bits']} bits, {rng['inexact_sums']} sums not "
            f"exact in the {rng['states_read']} states read")
        del Dd, st

        # nj and upgma: the card against CPU tensors.  Picks and
        # survivors bit-equal; the limbs and the last distance read row
        # sums, which on this matrix leave float64's exact range (each
        # join halves a sum of cells), so a parallel sum on the card may
        # differ from the CPU's in the last bit: within 1e-12
        for method in ("nj", "upgma"):
            got, t = synced(lambda: snj.sharded_join_records(
                Dn, n, method, torch.float64))
            want = cpu[method].result()
            for k in (0, 1, 4, 5):  # I, J, a, b
                np.testing.assert_array_equal(got[k], want[k])
            rel = sum_diff([got[2], got[3], got[6]],
                           [want[2], want[3], want[6]])
            differ = int((got[2] != want[2]).sum() + (got[3] != want[3]).sum())
            assert rel <= 1e-12, (method, rel)
            out[method] = {"n": n, "s": t, "joins_per_s": (n - 2) / t,
                           "limbs_differing": differ, "max_diff": rel}
            log(f"sharded_join_records -m {method} n={n} world 1 (NCCL): "
                f"{t:.2f} s, {(n - 2) / t:,.1f} joins/s; picks and survivors "
                f"equal the same function on CPU tensors (gloo), {differ} of "
                f"{2 * (n - 2)} limbs differ, by at most {rel:.3e}")


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
    for method in TREE_METHODS + ("dnj plain loop",):
        if method == "dnj":  # one dnj_segment_float launch a stretch
            st, seg = te._new_state(D0.to(dev), n), te._run_segment
        elif method == "dnj plain loop":
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
# phase 9: the CLI on the card against the CLI on the host code


def cli_run(args, env, cwd):
    """(stdout, stderr, seconds) of one port command, which must exit 0."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "ccphylo_tpu_torch"]
                       + args, env=env, cwd=cwd, capture_output=True,
                       timeout=300)
    assert p.returncode == 0, (args, p.stderr.decode(errors="replace"))
    return p.stdout, p.stderr, time.perf_counter() - t0


def cli_run_all(jobs, cwd):
    """{key: (args, env)} -> {key: (stdout, stderr, seconds)}; the
    processes run side by side (each takes seconds to import and reach
    the card)."""
    with ThreadPoolExecutor(min(len(jobs), 16)) as pool:
        futs = {k: pool.submit(cli_run, a, e, cwd)
                for k, (a, e) in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


def write_kma_db(d, name, seqs, names):
    """A KMA index (.length.b, .seq.b, .name): template 0 a placeholder,
    base j of a template at bits 62-2j of its u64 words."""
    code = {65: 0, 67: 1, 71: 2, 84: 3}
    lengths = np.zeros(len(seqs) + 1, np.int32)
    with open(os.path.join(d, name + ".seq.b"), "wb") as fh:
        for i, sq in enumerate(seqs, 1):
            lengths[i] = len(sq)
            w = np.zeros((len(sq) >> 5) + 1, np.uint64)
            for j, b in enumerate(sq):
                w[j >> 5] |= np.uint64(code[b]) << np.uint64(62 - 2 * (j & 31))
            w.tofile(fh)
    with open(os.path.join(d, name + ".length.b"), "wb") as fh:
        np.int32(len(seqs) + 1).tofile(fh)
        lengths.tofile(fh)
    with open(os.path.join(d, name + ".name"), "wb") as fh:
        fh.write(b"\n".join(names) + b"\n")


def host_subcommand_inputs(d, rng):
    """Small seeded inputs of merge, tsv2phy, tsv2nwck, makespan, union
    and seq2fasta: a jobs table, four KMA .res files, a KMA index and a
    tsv of rows."""
    rows = [b"#id\tsize\tcluster\tw"]
    for i in range(60):
        rows.append(b"%d\t%d\t%d\t%.2f" % (i, rng.randint(1, 50),
                                           rng.randint(0, 12),
                                           rng.uniform(0.5, 9.0)))
    Path(d, "jobs.tsv").write_bytes(b"\n".join(rows) + b"\n")
    tpls = [b"tplA", b"tplB", b"tplC", b"tplD", b"tplE"]
    head = (b"#Template\tScore\tExpected\tTemplate_length\t"
            b"Template_Identity\tTemplate_Coverage\tQuery_Identity\t"
            b"Query_Coverage\tDepth\tq_value\tp_value\n")
    for s in range(4):
        out = [head]
        for t in tpls:
            cov = rng.uniform(20, 100)
            out.append(b"%s\t%d\t%d\t%d\t%.2f\t%.2f\t%.2f\t%.2f\t%.2f\t"
                       b"%.1f\t1.0e-10\n"
                       % (t, rng.randint(100, 10**5), rng.randint(1, 100),
                          rng.randint(500, 5000), rng.uniform(80, 100), cov,
                          rng.uniform(80, 100), cov, rng.uniform(0.5, 60),
                          rng.uniform(10, 1000)))
        Path(d, f"r{s}.res").write_bytes(b"".join(out))
    write_kma_db(d, "db", [bytes(rng.choice(list(b"ACGT"),
                                            rng.randint(40, 120)).tolist())
                           for _ in tpls], tpls)
    rows = ["\t".join(f"c{i}" for i in range(6))]
    for _ in range(10):
        rows.append("\t".join(f"{v:.3f}" for v in rng.rand(6) * 50))
    Path(d, "t.tsv").write_text("\n".join(rows) + "\n")


def cli_host_subcommands(d, env, fsas, mats, out_dist, out_tree):
    """The twelve host subcommands, side by side: phycmp of the card's
    dist matrix against the host route's; fullphy, dbscan and nwck2phy
    of the card's outputs byte-equal to the same of the host route's;
    merge, tsv2phy, tsv2nwck, makespan, union, rarify, trim and
    seq2fasta on small seeded inputs.  Each must exit 0."""
    t0 = time.perf_counter()
    host_subcommand_inputs(d, np.random.RandomState(SEED))
    for name, data in (("card.phy", out_dist[0]), ("host.phy", out_dist[1]),
                       ("card.nwck", out_tree[0]),
                       ("host.nwck", out_tree[1])):
        Path(d, name).write_bytes(data)
    Path(d, "m.phy").write_bytes(out_dist[0] + out_dist[1])
    res4 = [f"r{s}.res" for s in range(4)]
    jobs = {"phycmp": ["phycmp", "-i", "card.phy", "host.phy", "-f", "127"],
            "merge": ["merge", "-i", "m.phy"],
            "tsv2phy": ["tsv2phy", "-i", "t.tsv"],
            "tsv2nwck": ["tsv2nwck", "-i", "t.tsv"],
            "makespan": ["makespan", "-i", "jobs.tsv", "-l", "3"],
            "union": ["union", "-i"] + res4,
            "union -B": ["union", "-i"] + res4 + ["-B", "db", "-o", "u.tsv"],
            "rarify": ["rarify", "-i", mats[0], "-A", "100000"],
            "trim": ["trim", "-i"] + fsas + ["-r", "tpl1", "-f", "1"],
            "seq2fasta": ["seq2fasta", "-t_db", "db"]}
    for cmd, ext in (("fullphy", "phy"), ("dbscan", "phy"),
                     ("nwck2phy", "nwck")):
        for side in ("card", "host"):
            jobs[f"{cmd} {side}"] = [cmd, "-i", f"{side}.{ext}"]
    out = cli_run_all({k: (a, env) for k, a in jobs.items()}, d)
    for cmd in ("fullphy", "dbscan", "nwck2phy"):
        assert out[cmd + " card"][0] == out[cmd + " host"][0], cmd
    assert all(out[k][0] for k in jobs if k != "union -B"), \
        [k for k in jobs if not out[k][0]]
    assert Path(d, "u.tsv").read_bytes()
    names = {a[0] for a in jobs.values()}
    assert len(names) == 12, names
    return time.perf_counter() - t0, len(jobs)


def cli_trace(d, env, fsas, dist17):
    """dist -f 17 and tree -m dnj -b on the card, each under
    CCPHYLO_TORCH_PROFILE=<its own dir>, and the same tree without the
    profiler, for what the trace costs: three processes side by side.
    The trees read the phase's untraced dist -f 17 matrix (`dist17`),
    which the traced dist must equal; each trace parses as JSON and its
    `kernel` events name the kernel the command runs."""
    phy = os.path.join(d, "d17.phy")
    Path(phy).write_bytes(dist17)
    tree_args = ["tree", "-m", "dnj", "-b", "-i", phy]
    runs = {"dist": (["dist", "-r", "tpl1", "-f", "17", "-i"] + fsas,
                     ("expand_shared_kernel",)),
            "tree": (tree_args, ("dnj_segment_kernel",))}
    jobs = {cmd: (args, dict(env, CCPHYLO_TORCH_PROFILE=os.path.join(
        d, "prof_" + cmd))) for cmd, (args, _) in runs.items()}
    jobs["tree untraced"] = (tree_args, env)
    out = cli_run_all(jobs, d)
    assert out["dist"][0] == dist17
    assert out["tree"][0] == out["tree untraced"][0]
    assert out["tree"][0].endswith(b";\n")
    info = {}
    for cmd, (_, want) in runs.items():
        prof, err = os.path.join(d, "prof_" + cmd), out[cmd][1]
        assert b"# --- ccphylo_tpu_torch profile ---" in err, err
        assert b"profiler trace unavailable" not in err, err
        files = list(Path(prof).glob("ccphylo_tpu_torch.*.pt.trace.json"))
        assert len(files) == 1 and len(os.listdir(prof)) == 1, files
        events = json.loads(files[0].read_text())["traceEvents"]
        kernels = [e.get("name", "") for e in events
                   if e.get("cat") == "kernel"]
        launches = {w: sum(w in k for k in kernels) for w in want}
        assert all(launches.values()), (cmd, sorted(set(kernels)))
        info[cmd] = {"kernel_events": len(kernels),
                     "trace_bytes": files[0].stat().st_size,
                     "launches": launches, "process_s": out[cmd][2]}
    info["tree"]["process_s_untraced"] = out["tree untraced"][2]
    return info


def phase_cli(res):
    sys.path.insert(0, REPO)
    from tests.gen_kma_data import make_dataset

    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("CCPHYLO_TPU_", "CCPHYLO_TORCH_", "JAX_"))}
    base["PYTHONPATH"] = REPO
    # no CCPHYLO_TORCH_* variable: the card and the packed engine
    host_env = dict(base, CCPHYLO_TORCH_DIST="host",
                    CCPHYLO_TORCH_ENGINE="exact")

    def cells(out):
        return [float(x) for ln in out.split(b"\n")[1:] if ln
                for x in ln.split(b"\t")[1:]]

    dev_env = dict(base, CCPHYLO_TORCH_DIST="device")
    with tempfile.TemporaryDirectory() as d:
        make_dataset(Path(d), n_samples=24, length=3000)
        fsas = sorted(f for f in os.listdir(d) if f.endswith(".fsa.gz"))
        mats = sorted(f for f in os.listdir(d) if f.endswith(".mat.gz"))
        jobs = {}
        for flag in ("17", "19"):
            args = ["dist", "-r", "tpl1", "-f", flag, "-i"] + fsas
            jobs["-f " + flag] = (args, base)
            jobs["-f " + flag + " host"] = (args, host_env)
        # dist on .mat.gz: -d l1 and -d z on the card by default, -d cos
        # on the host with its note, and on the card when asked
        for method in ("l1", "z", "cos"):
            args = ["dist", "-r", "tpl1", "-d", method, "-i"] + mats
            jobs["-d " + method] = (args, base)
            jobs["-d " + method + " host"] = (args, host_env)
        jobs["-d cos device"] = (jobs["-d cos"][0], dev_env)
        out = dist_out = cli_run_all(jobs, d)
        for key in ("-f 17", "-f 19", "-d l1", "-d z", "-d cos"):
            assert out[key][0] == out[key + " host"][0], key
            assert out[key][0].count(b"\n") == 25
            noted = out[key][1].count(b"# ccphylo_tpu_torch")
            assert noted == (key == "-d cos"), (key, out[key][1])
        assert b"CCPHYLO_TORCH_DIST=device" in out["-d cos"][1]
        card, host = cells(out["-d cos device"][0]), cells(out["-d cos"][0])
        worst = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(card, host))
        assert len(card) == len(host) == 276 and worst <= 1e-9

        phy = os.path.join(d, "d.phy")
        with open(phy, "wb") as fh:
            fh.write(out["-f 19"][0])
        # -m dnj -b: the packed engine; -m nj, -m dnj: the float64 device
        # engines (an integer matrix, no variable set); -m dnj under
        # CCPHYLO_TORCH_ENGINE=sharded (float32, as in the reference),
        # against the same command on CPU tensors
        jobs = {}
        for targs in (["-m", "dnj", "-b"], ["-m", "nj"], ["-m", "dnj"]):
            args = ["tree"] + targs + ["-i", phy]
            jobs[" ".join(targs)] = (args, base)
            jobs[" ".join(targs) + " host"] = (args, host_env)
        args = ["tree", "-m", "dnj", "-i", phy]
        jobs["sharded"] = (args, dict(base, CCPHYLO_TORCH_ENGINE="sharded"))
        jobs["sharded host"] = (args, dict(base, CCPHYLO_TORCH_ENGINE="sharded",
                                           CCPHYLO_TORCH_DEVICE="cpu"))
        out = cli_run_all(jobs, d)
        for key in ("-m dnj -b", "-m nj", "-m dnj", "sharded"):
            assert out[key][0] == out[key + " host"][0], key
            assert out[key][0].endswith(b";\n")
        dist_pair = (dist_out["-f 19"][0], dist_out["-f 19 host"][0])
        tree_pair = (out["-m dnj -b"][0], out["-m dnj -b host"][0])
        secs, nproc = cli_host_subcommands(d, base, fsas, mats, dist_pair,
                                           tree_pair)
        res["cli_host_subcommands_s"] = secs
        log(f"CLI: the twelve host subcommands ({nproc} processes side by "
            f"side) exit 0 in {secs:.2f} s; fullphy, dbscan and nwck2phy "
            "of the card's dist matrix and tree -m dnj -b Newick equal "
            "those of the host route's")
        trace = res["cli_trace"] = cli_trace(d, base, fsas,
                                             dist_out["-f 17"][0])
        log("CLI trace (CCPHYLO_TORCH_PROFILE=<dir>): " + "; ".join(
            f"{cmd}: {t['kernel_events']} kernel events (of them "
            f"{t['launches']}), {t['trace_bytes']} bytes, process "
            f"{t['process_s']:.2f} s" for cmd, t in trace.items())
            + "; tree without the profiler "
            f"{trace['tree']['process_s_untraced']:.2f} s")
    res["cli_mat_cos_device_max_rel"] = worst
    log("CLI dist -f 17 / -f 19, tree -m dnj -b, tree -m nj and tree -m "
        "dnj on the card equal the host code's bytes, tree -m dnj under "
        "CCPHYLO_TORCH_ENGINE=sharded (NCCL) the same on CPU tensors "
        "(gloo); dist on .mat.gz: "
        "-d l1 and -d z on the card equal the host metrics' bytes, -d cos "
        "runs on the host with its note, and on the card under "
        f"CCPHYLO_TORCH_DIST=device within {worst:.1e} of the host's cells")


# ---------------------------------------------------------------------
# phase 10: the compile check and dry run (ccphylo_tpu_torch/dryrun.py)


def phase_dryrun(dev, res):
    """entry()'s SNP matrix on the card, bit-equal to the same function
    on CPU tensors (the plain expansion); with one card,
    dryrun_multichip(2) raising before it starts a process; then, side
    by side, dryrun_multichip(1) on the card (NCCL), the same call on
    CPU tensors (gloo) and the command line `python -m
    ccphylo_tpu_torch.dryrun`: every stage's records of the card's run
    equal the CPU run's, and its rank launched snp_expand_shared,
    dnj_segment and qrow_mins through slots."""
    out = res["dryrun"] = {"build_s": build.build_all()}
    fn, args = dryrun.entry(dev)
    build.reset_launches()
    D, out["entry_s"] = synced(lambda: fn(*args))
    assert build.launches["snp_expand_shared"] > 0, build.launches
    assert torch.equal(D.cpu(), fn(*(a.cpu() for a in args)))
    if torch.cuda.device_count() == 1:
        started, popen = [], subprocess.Popen
        subprocess.Popen = lambda *a, **k: started.append(a)
        try:
            dryrun.dryrun_multichip(2, device="cuda")
        except ValueError as e:
            out["world2_refused"] = str(e)
        finally:
            subprocess.Popen = popen
        assert "world2_refused" in out and not started, started
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CCPHYLO_TPU_", "CCPHYLO_TORCH_", "JAX_"))}
    env["PYTHONPATH"] = REPO
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        card = pool.submit(dryrun.dryrun_multichip, 1, device="cuda")
        cpu = pool.submit(dryrun.dryrun_multichip, 1, device="cpu")
        cli = pool.submit(subprocess.run,
                          [sys.executable, "-m", "ccphylo_tpu_torch.dryrun"],
                          env=env, cwd=REPO, capture_output=True,
                          timeout=300)
        card, cpu, cli = card.result(), cpu.result(), cli.result()
    out["side_by_side_s"] = time.perf_counter() - t0
    assert cli.returncode == 0, cli.stderr.decode(errors="replace")
    out["cli"] = cli.stdout.decode().splitlines()
    assert out["cli"][-1].startswith("dryrun_multichip(1) on cuda: "), \
        out["cli"]
    ours, theirs = dryrun.records(card), dryrun.records(cpu)
    assert ours.keys() == theirs.keys()
    differ = [k for k in ours if not np.array_equal(ours[k], theirs[k])]
    assert not differ, differ
    out["stage_s"] = {k: float(card["seconds/" + k]) for k in dryrun.STAGES}
    out["stage_s_cpu"] = {k: float(cpu["seconds/" + k])
                          for k in dryrun.STAGES}
    out["launches"] = {k[len("launches/"):]: int(v) for k, v in card.items()
                       if k.startswith("launches/")}
    for k in ("snp_expand_shared", "dnj_segment", "qrow_mins_slots",
              "dnj_segment_float"):
        assert out["launches"][k] > 0, out["launches"]
    log(f"dry run: entry() {out['entry_s']:.4f} s, equal to its CPU "
        f"result; dryrun_multichip(1) on the card equals it on CPU tensors "
        f"({len(ours)} arrays); card stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in out["stage_s"].items())
        + "; launches " + ", ".join(f"{k} {v}" for k, v in
                                    out["launches"].items())
        + f"; three processes side by side {out['side_by_side_s']:.1f} s"
        + (f"; world 2 refused: {out['world2_refused']}"
           if "world2_refused" in out else ""))


PHASES = ("kernels", "main_path", "scale", "parity", "streamed", "engines",
          "sharded", "matdist", "cli", "dryrun", "profile", "float_sizes",
          "dist_ring")


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
    # the main path's SNP matrix, for the engines phase, and phase 4's
    # u8 matrix, for the streamed phase
    shared = {}
    for name, phase in zip(PHASES, (
            lambda: phase_kernels(dev, g, res),
            lambda: shared.update(flat=phase_main_path(dev, g, res)),
            lambda: shared.update(D8=phase_scale(dev, g, res)),
            lambda: phase_parity(dev, res),
            lambda: phase_streamed(dev, g, res, shared.pop("D8", None)),
            lambda: phase_engines(dev, g, res, shared.get("flat")),
            lambda: phase_sharded(dev, res, shared.get("flat")),
            lambda: phase_matdist(dev, res),
            lambda: phase_cli(res), lambda: phase_dryrun(dev, res),
            lambda: phase_profile(dev, res),
            lambda: phase_float_sizes(dev, res),
            lambda: phase_dist_ring(dev, res))):
        if name in only or (not only and name not in ("profile",
                                                      "float_sizes",
                                                      "dist_ring")):
            t_phase = time.perf_counter()
            phase()
            res.setdefault("phase_s", {})[name] = \
                time.perf_counter() - t_phase
            log(f"phase {name}: {res['phase_s'][name]:.1f} s")
    res["total_s"] = time.perf_counter() - t_start

    card = card_line()
    print(json.dumps({"results": res}))
    print(card)
    if only:
        return 0
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        ms, plain = res["kernel_ms"][name]
        keys, path = KERNEL_PATH.get(name, (("main_path_launches",),
                                            "main"))
        counts = functools.reduce(lambda d, k: d[k], keys, res)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "path": path,
                        "launches": counts[name],
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
