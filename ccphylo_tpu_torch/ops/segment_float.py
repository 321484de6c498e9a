"""A segment of joins of the float DNJ engine (counterpart of the device
loop of joins `_dnj_segment`, tree/jax_engine.py:453-461, with its join
`_mk_one_join`, :224-450, and scan="batch").

- `dnj_segment_float` (csrc/dnj_segment_float.cu): joins [t0, t1) in one
  cooperative launch of K blocks, every scan pass and every join body of
  the segment with no host read and no other launch.  On a CUDA tensor
  it launches the kernel or raises; on a CPU tensor it runs the plain
  version.
- `dnj_segment_float_plain`: the loop of tree/torch_engine.py's
  `_one_join` with scan="batch".  Per join: the batch scan
  (`_batch_scan`) recomputes the candidate rows (cached Q below the
  running minimum) KBATCH at a time as one (K, m_t) block, and each of
  its passes ends in one host read of the candidate count and the pair
  so far, so the rest of the join indexes rows and columns with plain
  integers over the m_t active taxa; the limbs (nj.c:42-109) come from
  one more host read of five values (and the exact flag), in the
  state's precision; where the JAX body gates every write by a mask,
  the loop branches on the host.  The masked scatters of the reference
  (``.at[tgt].add(..., mode="drop")``) send their dropped entries to
  slot j, which the same update overwrites right after; every other
  target is distinct, so the scatter is deterministic on CUDA.  The
  host reads are free on the CPU.

Both take the engine's state tensors in the order of STATE_KEYS: D (n,
n), sD, N, Q, P, seed, the records I, J, LI, LJ at row t of join t, the
exact flag (a bool tensor, or None where the run does not track float's
exact range), first_inexact ((1,) int32) and stats ((2,) int64: scan
passes, rows whose cache a scan rewrote); then the joins [t0, t1), the
taxa m (join t has m - t active rows) and neg_limbs; and update the
state in place.  With the exact flag given, a join whose pair would
read a row sum outside the exact range (the flag false) stops the
segment before its limbs: first_inexact is set to it, and the engine
raises InexactSums(first_inexact) at the fence.

The kernel comes in an instance for complete matrices (no missing
active cell, which a run keeps) and one with missing cells;
`dnj_segment_float_prepare` picks it once a run, with one host read.
Its flags (the results are the same): ROWS the first design of its
scan (every block walks Q through L2 twice a pass, block k scans the
whole row of rank k); without it the candidate-list design (a list of
the join's candidate rows, the pass's cells split evenly over the
blocks), with STAGE_Q building the list from a copy of Q in shared
memory (one bulk copy a join; dropped where Q does not fit) and without
it from slices of Q compacted by every block, one more grid barrier a
join.  A run takes the faster on an H100 by size (`default_design`,
from the designs timed in turns: PERF.md §5).  PROFILE: the SM clock
cycles each block spends in each part of a join (PHASES;
`segment_float_profile`, `segment_float_block_profile`).  The list's
capacity (K rows, one pass's) and what a piece of a row costs beside
its cells (2048 units) are constants of the kernel (kListK, kPieceUnits); the
list is a window on the join's candidates, which are read once a join
and top it up after a pass where they are more
(`segment_float_refills` counts the top-ups).
"""

from __future__ import annotations

import torch

from . import build
from .segment import check_segment_range
from ..tree import torch_engine as te

STATE_KEYS = ("D", "sD", "N", "Q", "P", "seed", "I", "J", "LI", "LJ",
              "exact", "first_inexact", "stats")
FLOAT32, COMPLETE = 1, 2  # the kernel's instance flags
PROFILE = 4  # each block's SM clock cycles by part of a join (PHASES)
ROWS, STAGE_Q = 8, 16  # the first design; the copy of Q in shared memory
# the design a run takes by default, by size, from the designs timed in
# turns on an H100 (PERF.md §5): ROWS below ROWS_BELOW taxa, else the
# candidate list, from the copy of Q up to STAGE_Q_ROWS rows
ROWS_BELOW = 2560
STAGE_Q_ROWS = 16384
# the build that launches: ops/build.py's `variant` of the source with
# other constants, for chip_smoke.py's turns of them, else the source's
STEM = "dnj_segment_float"
COUNTERS = 16  # int64 counters at the scratch's start: PHASES, serial,
REFILLS = 15   # and the list's refills
# the parts of a join that PROFILE times, in the kernel's order
PHASES = ("copy of Q", "select", "list barrier", "row", "pass barrier",
          "reduce", "limbs", "A0", "barrier A0", "A", "barrier A", "B",
          "barrier B", "C")
_max_blocks: dict = {}  # (device, STEM, flags, n, K) -> co-resident blocks


def dnj_segment_float_plain(D, sD, N, Q, P, seed, I, J, LI, LJ, exact,
                            first_inexact, stats, t0: int, t1: int, m: int,
                            neg_limbs=False) -> None:
    """Joins [t0, t1) in plain PyTorch: `_one_join` with scan="batch"
    per join; a join that raises InexactSums sets first_inexact and ends
    the segment."""
    st = {"D": D, "sD": sD, "N": N, "Q": Q, "P": P, "seed": seed.clone(),
          "I": I, "J": J, "LI": LI, "LJ": LJ,
          "idx": torch.arange(D.shape[0], device=D.device)}
    if exact is not None:
        st["exact"] = exact
    try:
        for t in range(t0, t1):
            te._one_join(st, t, m, neg_limbs, "batch", stats)
    except te.InexactSums as e:
        first_inexact.fill_(e.join)
    finally:
        seed.copy_(st["seed"])


def check_segment_float_args(D, sD, N, Q, P, seed, I, J, LI, LJ, exact,
                             first_inexact, stats, K: int, max_blocks: int,
                             rows: bool = True) -> None:
    """Raise ValueError unless the state suits the dnj_segment_float
    kernel: D (n, n) float64 or float32; sD, Q, LI, LJ (n,) of D's type;
    N, P, I, J (n,) int32; seed (1,) int64; exact None or one bool;
    first_inexact (1,) int32; stats (2,) int64; all contiguous on one
    device; D, sD, N and Q 16-byte aligned; and 1 <= K <= max_blocks
    (the co-resident blocks of a cooperative launch), in the
    candidate-list design (`rows` false) also K <= 256 (a block scans
    one entry of the list a thread)."""
    dev = D.device
    if D.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"D: expected float64 or float32, not {D.dtype}")
    typed = [("D", D, D.dtype), ("sD", sD, D.dtype), ("Q", Q, D.dtype),
             ("LI", LI, D.dtype), ("LJ", LJ, D.dtype)]
    typed += [(k, x, torch.int32) for k, x in (("N", N), ("P", P), ("I", I),
                                               ("J", J))]
    typed += [("seed", seed, torch.int64),
              ("first_inexact", first_inexact, torch.int32),
              ("stats", stats, torch.int64)]
    if exact is not None:
        typed.append(("exact", exact, torch.bool))
    for name, x, dtype in typed:
        if not isinstance(x, torch.Tensor) or x.dtype != dtype \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor "
                             f"on {dev}")
    n = D.shape[0]
    if D.dim() != 2 or D.shape[1] != n \
            or any(x.shape != (n,) for _, x, _ in typed[1:9]) \
            or seed.shape != (1,) or first_inexact.shape != (1,) \
            or stats.shape != (2,) \
            or (exact is not None and exact.numel() != 1):
        raise ValueError("bad shapes: " + ", ".join(
            f"{k} {tuple(x.shape)}" for k, x, _ in typed))
    if any(x.data_ptr() % 16 for x in (D, sD, N, Q)):
        raise ValueError("D, sD, N and Q must be 16-byte aligned")
    if not 1 <= K <= max_blocks:
        raise ValueError(
            f"K = {K}: a cooperative launch of dnj_segment_float holds 1 "
            f"to {max_blocks} blocks on {dev} (a value <= 0 is a CUDA "
            "error code or a card without cooperative launch)")
    if not rows and K > 256:
        raise ValueError(f"K = {K}: the candidate-list design takes at "
                         "most 256 blocks")


def instance_flags(D, m: int) -> int:
    """The kernel's instance for the m active taxa of D: FLOAT32 for
    float32 state, COMPLETE where no active cell is missing (one host
    read)."""
    complete = bool((D[:m, :m] >= 0).all())
    return (FLOAT32 if D.dtype == torch.float32 else 0) \
        | (COMPLETE if complete else 0)


def default_design(n: int, m: int) -> int:
    """The design flags a run over m taxa of an (n, n) matrix takes by
    default: ROWS below ROWS_BELOW taxa, else the candidate list, with
    STAGE_Q up to STAGE_Q_ROWS rows."""
    if m < ROWS_BELOW:
        return ROWS
    return STAGE_Q if n <= STAGE_Q_ROWS else 0


def prepare_flags(D, m: int, flags: int | None = None) -> int:
    """The instance's flags (`instance_flags`) and `flags`, or by default
    `default_design`'s."""
    if flags is None:
        flags = default_design(D.shape[0], m)
    return instance_flags(D, m) | int(flags)


def dnj_segment_float_prepare(D, sD, N, Q, P, seed, I, J, LI, LJ, exact,
                              first_inexact, stats, m: int,
                              K: int | None = None, flags: int | None = None):
    """Check the state once for a run of `dnj_segment_float` launches over
    m taxa, pick the kernel's instance (`instance_flags`) and allocate
    the scratch (zeroed: PROFILE adds to its counters); returns `prep`
    for `dnj_segment_float`: the scratch, K (default: the engine's
    KBATCH) and the flags (the instance's and `flags`, by default
    `default_design`'s; STAGE_Q dropped where the copy of Q does not fit
    in a block's shared memory beside the lists)."""
    dev = D.device
    n = D.shape[0]
    K = te.KBATCH if K is None else int(K)
    flags = prepare_flags(D, m, flags)
    with torch.cuda.device(dev):
        if flags & STAGE_Q and not _fits(flags, n, K):
            flags &= ~STAGE_Q
        key = (dev, STEM, flags, n, K)
        if key not in _max_blocks:
            _max_blocks[key] = build.query(
                STEM, "dnj_segment_float_max_blocks", flags, n, K)
        check_segment_float_args(D, sD, N, Q, P, seed, I, J, LI, LJ, exact,
                                 first_inexact, stats, K, _max_blocks[key],
                                 bool(flags & ROWS))
        nbytes = build.query(STEM, "dnj_segment_float_scratch_bytes", K, n,
                             flags)
    scratch = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    return scratch, K, flags


def _fits(flags: int, n: int, K: int) -> bool:
    """Whether the shared memory of a launch of `flags` at n rows and K
    blocks fits in a block of the current device."""
    fits = build.query(STEM, "dnj_segment_float_fits", flags, n, K)
    if fits < 0:
        raise RuntimeError(f"dnj_segment_float_fits: CUDA error "
                           f"{-fits - 1}")
    return bool(fits)


def _counters(prep) -> list:
    return prep[0][:8 * COUNTERS].view(torch.int64).tolist()


def segment_float_profile(prep) -> dict:
    """SM clock cycles that block 0 spent in each part of the joins of
    every PROFILE launch made with `prep` (one host read)."""
    return dict(zip(PHASES, _counters(prep)))


def segment_float_block_profile(prep) -> torch.Tensor:
    """SM clock cycles that each block spent in each part of the joins of
    every PROFILE launch made with `prep`: (K, len(PHASES)) int64 on the
    host (one host read)."""
    K = prep[1]
    at = 8 * COUNTERS
    return prep[0][at:at + 8 * K * len(PHASES)].view(torch.int64) \
        .view(K, len(PHASES)).cpu()


def segment_float_refills(prep) -> int:
    """Refills of the candidate list from Q (passes of joins with more
    candidates than the list holds) in every launch made with `prep`
    (one host read)."""
    return _counters(prep)[REFILLS]


def dnj_segment_float(D, sD, N, Q, P, seed, I, J, LI, LJ, exact,
                      first_inexact, stats, t0: int, t1: int, m: int,
                      neg_limbs=False, prep=None) -> None:
    """`dnj_segment_float_plain`'s contract.  On a CUDA tensor: the
    dnj_segment_float kernel, one cooperative launch for the whole
    segment.  `prep` (from `dnj_segment_float_prepare` on the same
    tensors and m) skips the checks of the state, the choice of the
    instance and the scratch allocation, and sets the design; t0, t1
    and m are checked on every call."""
    if D.device.type == "cpu":
        return dnj_segment_float_plain(D, sD, N, Q, P, seed, I, J, LI, LJ,
                                       exact, first_inexact, stats, t0, t1,
                                       m, neg_limbs)
    if prep is None:
        prep = dnj_segment_float_prepare(D, sD, N, Q, P, seed, I, J, LI, LJ,
                                         exact, first_inexact, stats, m)
    scratch, K, flags = prep
    n = D.shape[0]
    check_segment_range(t0, t1, m, n)
    build.launch(STEM, "dnj_segment_float", D.data_ptr(), n,
                 sD.data_ptr(), N.data_ptr(), Q.data_ptr(), P.data_ptr(),
                 seed.data_ptr(), I.data_ptr(), J.data_ptr(), LI.data_ptr(),
                 LJ.data_ptr(), None if exact is None else exact.data_ptr(),
                 first_inexact.data_ptr(), stats.data_ptr(), int(t0),
                 int(t1), int(m), int(bool(neg_limbs)), K,
                 scratch.data_ptr(), flags, device=D.device)
