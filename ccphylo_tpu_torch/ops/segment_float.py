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
"""

from __future__ import annotations

import torch

from . import build
from .segment import check_segment_range
from ..tree import torch_engine as te

STATE_KEYS = ("D", "sD", "N", "Q", "P", "seed", "I", "J", "LI", "LJ",
              "exact", "first_inexact", "stats")
FLOAT32, COMPLETE = 1, 2  # the kernel's instance flags
_max_blocks: dict = {}    # (device, flags) -> co-resident blocks


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
                             first_inexact, stats, K: int,
                             max_blocks: int) -> None:
    """Raise ValueError unless the state suits the dnj_segment_float
    kernel: D (n, n) float64 or float32; sD, Q, LI, LJ (n,) of D's type;
    N, P, I, J (n,) int32; seed (1,) int64; exact None or one bool;
    first_inexact (1,) int32; stats (2,) int64; all contiguous on one
    device; and 1 <= K <= max_blocks (the co-resident blocks of a
    cooperative launch)."""
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
    if not 1 <= K <= max_blocks:
        raise ValueError(
            f"K = {K}: a cooperative launch of dnj_segment_float holds 1 "
            f"to {max_blocks} blocks on {dev} (a value <= 0 is a CUDA "
            "error code or a card without cooperative launch)")


def instance_flags(D, m: int) -> int:
    """The kernel's instance for the m active taxa of D: FLOAT32 for
    float32 state, COMPLETE where no active cell is missing (one host
    read)."""
    complete = bool((D[:m, :m] >= 0).all())
    return (FLOAT32 if D.dtype == torch.float32 else 0) \
        | (COMPLETE if complete else 0)


def dnj_segment_float_prepare(D, sD, N, Q, P, seed, I, J, LI, LJ, exact,
                              first_inexact, stats, m: int,
                              K: int | None = None):
    """Check the state once for a run of `dnj_segment_float` launches over
    m taxa, pick the kernel's instance (`instance_flags`) and allocate
    the scratch; returns `prep` for `dnj_segment_float`: the scratch, K
    (default: the engine's KBATCH) and the flags."""
    dev = D.device
    K = te.KBATCH if K is None else int(K)
    flags = instance_flags(D, m)
    key = (dev, flags)
    with torch.cuda.device(dev):
        if key not in _max_blocks:
            _max_blocks[key] = build.query(
                "dnj_segment_float", "dnj_segment_float_max_blocks", flags)
        check_segment_float_args(D, sD, N, Q, P, seed, I, J, LI, LJ, exact,
                                 first_inexact, stats, K, _max_blocks[key])
        nbytes = build.query("dnj_segment_float",
                             "dnj_segment_float_scratch_bytes", K,
                             D.shape[0], flags)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return scratch, K, flags


def dnj_segment_float(D, sD, N, Q, P, seed, I, J, LI, LJ, exact,
                      first_inexact, stats, t0: int, t1: int, m: int,
                      neg_limbs=False, prep=None) -> None:
    """`dnj_segment_float_plain`'s contract.  On a CUDA tensor: the
    dnj_segment_float kernel, one cooperative launch for the whole
    segment.  `prep` (from `dnj_segment_float_prepare` on the same
    tensors and m) skips the checks of the state, the choice of the
    instance and the scratch allocation; t0, t1 and m are checked on
    every call."""
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
    build.launch("dnj_segment_float", "dnj_segment_float", D.data_ptr(), n,
                 sD.data_ptr(), N.data_ptr(), Q.data_ptr(), P.data_ptr(),
                 seed.data_ptr(), I.data_ptr(), J.data_ptr(), LI.data_ptr(),
                 LJ.data_ptr(), None if exact is None else exact.data_ptr(),
                 first_inexact.data_ptr(), stats.data_ptr(), int(t0),
                 int(t1), int(m), int(bool(neg_limbs)), K,
                 scratch.data_ptr(), flags, device=D.device)
