"""A segment of joins of the packed DNJ engine (counterpart of the device
loop of joins `_packed_segment`, tree/packed_engine.py:450-458, with
its join `one_join`, :151-345).

- `dnj_segment` (csrc/dnj_segment.cu): joins [t0, t1) in one
  cooperative launch of K blocks, every scan pass and every join body
  of the segment with no host read and no other launch.  On a CUDA
  tensor it launches the kernel or raises; on a CPU tensor it runs the
  plain version.
- `dnj_segment_plain`: the loop over the joins of ops/scan.py's
  `dnj_scan_plain` then ops/join.py's `dnj_join_plain`, one host read of
  the pair (i, j) a join (free on the CPU).

Both take the engine's state tensors in the order of the engine's state
keys (words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2, stats), then the
joins [t0, t1), the taxa m (join t has m - t active rows) and the scan's
batch K, and update the state in place.

The kernel's flags (the results are the same): STAGE_Q the scan's
reads of Q from a copy in shared memory made by one bulk copy a join;
PROFILE the SM clock cycles block 0 spends in each part of a join
(PHASES), added up in the scratch (`segment_profile`).  FLAGS is the
default; `chip_smoke.py` times it against the scan reading Q through L2
(what runs where Q does not fit).
"""

from __future__ import annotations

import torch

from . import build
from .join import check_join_args, dnj_join_plain
from .scan import dnj_scan_plain

STAGE_Q, PROFILE = 1, 2
# the faster on an H100 (PERF.md): Q in shared memory
FLAGS = STAGE_Q
# the parts of a join that PROFILE times, in the kernel's order
PHASES = ("copy of Q", "select", "row", "pass barrier", "reduce", "A",
          "barrier A", "B", "barrier B", "C")
# csrc/dnj_segment.cu's dynamic shared memory: the mbarrier, then Q
# (4 bytes a row); what a block of an H100 may take besides the kernel's
# static shared memory
SMEM_HEAD = 128
MAX_DYNAMIC_SMEM = 227 * 1024 - 1024
SCRATCH_PER_BLOCK = 15  # two scan buffers of 3, a partial sum, 8 partials
_max_blocks: dict = {}  # (device, flags, n) -> co-resident blocks


def smem_bytes(flags: int, n: int) -> int:
    """Dynamic shared memory of a dnj_segment launch at n rows."""
    return SMEM_HEAD + (4 * n if flags & STAGE_Q else 0)


def segment_flags(n: int, flags: int | None = None) -> int:
    """The flags a launch at n rows takes: FLAGS by default, without
    STAGE_Q where Q does not fit in shared memory: n above
    (MAX_DYNAMIC_SMEM - SMEM_HEAD) / 4 = 57,824 rows (the largest padded
    size that keeps it is 57,344); the scan then reads Q through L2."""
    flags = FLAGS if flags is None else int(flags)
    if smem_bytes(flags, n) > MAX_DYNAMIC_SMEM:
        flags &= ~STAGE_Q
    return flags


def dnj_segment_plain(words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2, stats,
                      t0: int, t1: int, m: int, K: int) -> None:
    """Joins [t0, t1) in plain PyTorch: per join t (m_t = m - t active
    rows), `dnj_scan_plain` with co = 2 (m_t - 2), then `dnj_join_plain`
    on its result."""
    for t in range(t0, t1):
        m_t = m - t
        res = dnj_scan_plain(words, sD2, Q, P, seed, m_t, 2 * (m_t - 2), K)
        dnj_join_plain(words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2,
                       stats, res, t, m_t)


def check_segment_args(words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2,
                       stats, K: int, max_blocks: int) -> None:
    """Raise ValueError unless the state suits the dnj_segment kernel:
    the join body's state (`check_join_args`), n % 128 == 0, words, sD2
    and Q 16-byte aligned, and 1 <= K <= max_blocks (the co-resident
    blocks of a cooperative launch)."""
    check_join_args(words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2, stats,
                    1, 1)
    n = words.shape[0]
    if n % 128:
        raise ValueError(f"n = {n}: the kernel needs n % 128 == 0")
    if words.data_ptr() % 16 or sD2.data_ptr() % 16 or Q.data_ptr() % 16:
        raise ValueError("words, sD2 and Q must be 16-byte aligned")
    if not 1 <= K <= max_blocks:
        raise ValueError(
            f"K = {K}: a cooperative launch of dnj_segment holds 1 to "
            f"{max_blocks} blocks on {words.device} (a value <= 0 is a CUDA "
            "error code or a card without cooperative launch)")


def check_segment_range(t0: int, t1: int, m: int, n: int) -> None:
    """Raise ValueError unless 0 <= t0 <= t1 <= m - 2 and m <= n: every
    join of [t0, t1) has at least 3 active rows."""
    if not (0 <= t0 <= t1 <= m - 2 and m <= n):
        raise ValueError(f"t0 = {t0}, t1 = {t1}, m = {m}: need 0 <= t0 <= "
                         f"t1 <= m - 2 and m <= {n}")


def dnj_segment_prepare(words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2,
                        stats, K: int, flags: int | None = None):
    """Check the state once for a run of `dnj_segment` launches and
    allocate their scratch (zeroed: PROFILE adds to its counters);
    returns `prep` for `dnj_segment`: the scratch, K and the flags
    (`segment_flags`)."""
    dev = words.device
    n = words.shape[0]
    flags = segment_flags(n, flags)
    key = (dev, flags, n)
    if key not in _max_blocks:
        with torch.cuda.device(dev):
            _max_blocks[key] = build.query(
                "dnj_segment", "dnj_segment_max_blocks", flags, n)
    check_segment_args(words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2,
                       stats, K, _max_blocks[key])
    scratch = torch.zeros(_profile_at(K) + 2 * len(PHASES),
                          dtype=torch.int32, device=dev)
    return scratch, K, flags


def _profile_at(K: int) -> int:
    """int32 offset of the PROFILE counters in the scratch: after the
    kernel's 15 K, 8-byte aligned."""
    return (SCRATCH_PER_BLOCK * K + 1) // 2 * 2


def segment_profile(prep) -> dict:
    """SM clock cycles that block 0 spent in each part of the joins of
    every PROFILE launch made with `prep` (one host read)."""
    scratch, K, _ = prep
    at = _profile_at(K)
    cycles = scratch[at:at + 2 * len(PHASES)].view(torch.int64).tolist()
    return dict(zip(PHASES, cycles))


def dnj_segment(words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2, stats,
                t0: int, t1: int, m: int, K: int, prep=None) -> None:
    """`dnj_segment_plain`'s contract.  On a CUDA tensor: the dnj_segment
    kernel, one cooperative launch of K blocks for the whole segment.
    `prep` (from `dnj_segment_prepare` on the same tensors and K) skips
    the checks of the state and the scratch allocation, and sets the
    flags; t0, t1 and m are checked on every call."""
    if words.device.type == "cpu":
        return dnj_segment_plain(words, sD2, Q, P, seed, I, J, DIJ2, SDI2,
                                 SDJ2, stats, t0, t1, m, K)
    if prep is None:
        prep = dnj_segment_prepare(words, sD2, Q, P, seed, I, J, DIJ2,
                                   SDI2, SDJ2, stats, K)
    scratch, blocks, flags = prep
    if blocks != K:
        raise ValueError(f"K = {K}, but prep was made for K = {blocks}")
    n = words.shape[0]
    check_segment_range(t0, t1, m, n)
    build.launch("dnj_segment", "dnj_segment", words.data_ptr(), n,
                 sD2.data_ptr(), Q.data_ptr(), P.data_ptr(), seed.data_ptr(),
                 I.data_ptr(), J.data_ptr(), DIJ2.data_ptr(), SDI2.data_ptr(),
                 SDJ2.data_ptr(), stats.data_ptr(), int(t0), int(t1), int(m),
                 blocks, scratch.data_ptr(), flags, device=words.device)
