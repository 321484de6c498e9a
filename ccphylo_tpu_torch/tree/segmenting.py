"""Segmented dispatch of the join loops (counterpart of
tree/segmenting.py).

The join loop runs in segments of SEG joins.  Each segment is fenced
(``torch.cuda.synchronize()`` when the state lives on a card), so a
checkpoint or instrumentation hook sees a finished state and a fault
inside the segment surfaces at its end.  Each segment, its launch and
its fence, is one ``tree/segment`` span (utils/timing.py).  The
reference sizes its segments to a wall-clock target to stay under a TPU
runtime's execution watchdog; a CUDA card has none, so the size is fixed
here.
"""

from __future__ import annotations

import torch

from ..utils import timing

SEG = 1024  # joins per fenced segment


def _on_cuda(state) -> bool:
    vals = state.values() if isinstance(state, dict) else state
    return any(isinstance(v, torch.Tensor) and v.is_cuda for v in vals)


def run_segmented(seg_call, state, total: int, hooks=None,
                  start: int = 0):
    """Run join steps [start, total) as segments of SEG joins.

    seg_call(state, t0, t1) -> state runs steps [t0, t1).  hooks, if
    given, is called as hooks(state, done, total) after every fenced
    segment (checkpointing / instrumentation); `start` resumes the step
    counter mid-run (checkpoint restore).  Returns the final state."""
    cuda = _on_cuda(state)
    done = start
    while done < total:
        k = min(SEG, total - done)
        with timing.phase("tree/segment"):
            state = seg_call(state, done, done + k)
            if cuda:
                torch.cuda.synchronize()
        done += k
        if hooks is not None:
            hooks(state, done, total)
    return state
