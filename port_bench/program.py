"""What the program counts about itself in a traced run: the totals of
its spans and its counters (ccphylo_tpu_torch/utils/timing.py).

The program traces only while a torch.profiler records in its process
(the harness deletes CCPHYLO_TORCH_*), and a run's one profiler records
the traced window alone: the warm call before it and the check after it
run untraced.  So in a run of port_bench/run.py the totals are the
window's.  A program that keeps no such totals gives empty dicts, and
the readers that use them report nothing."""

from __future__ import annotations


def _timing():
    from ccphylo_tpu_torch.utils import timing
    return timing


def spans() -> dict:
    """name -> (total_s, count, self_s) of the program's spans."""
    read = getattr(_timing(), "spans", None)
    return read() if read is not None else {}


def counters() -> dict:
    """name -> value of the program's counters."""
    read = getattr(_timing(), "counters", None)
    return read() if read is not None else {}


def ms_per_span(*names: str):
    """Milliseconds of the spans `names` together per span of the first
    (a step each call opens once), or None where one is missing."""
    got = spans()
    if not all(n in got for n in names) or not got[names[0]][1]:
        return None
    return 1e3 * sum(got[n][0] for n in names) / got[names[0]][1]
