"""Spans, counters and the profiler trace: the port's one tracing API
(counterpart of ccphylo_tpu/utils/timing.py).

The reference's observability is two stderr timing lines around matrix
load and tree construction (tree.c:81-109); those exact lines are
emitted unconditionally by the CLI for parity.  This module adds the
port's own instrumentation, off by default so stdout/stderr stay
reference-shaped.

Tracing is on while CCPHYLO_TORCH_PROFILE is set (read once, at import)
or while a torch.profiler is recording in the process (checked at each
span's entry).  While it is on, every `phase` opens a
`torch.profiler.record_function` span of its name, so a profiler's
trace carries the program's spans on the clock of its device events,
and adds the span's seconds, its count and its self time (its seconds
less those of the spans it encloses) to totals that `spans()` returns;
`count` adds to counters that `counters()` returns.  While it is off, a
span costs one check and nothing is counted.  Span and counter names
have the form <area>/<step>.

- CCPHYLO_TORCH_PROFILE=stderr (or 1) — at process exit, every span's
  total, count and self time (and a rate where it was given items),
  then every counter, on stderr.
- CCPHYLO_TORCH_PROFILE=<dir> — additionally wraps the process in a
  torch.profiler trace (CPU, and CUDA when a card is present) from the
  first span to exit, written at exit as the Chrome trace
  <dir>/ccphylo_tpu_torch.<pid>.pt.trace.json (viewable in Perfetto or
  chrome://tracing), with the program's spans in it.  A profiler that
  cannot start prints "# profiler trace unavailable: <exc>" and the run
  goes on.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from contextlib import nullcontext

_MODE = os.environ.get("CCPHYLO_TORCH_PROFILE", "")
_spans: dict[str, list] = {}  # name -> [total_s, count, self_s]
_counters: dict[str, float] = {}
_open = threading.local()  # .stack: this thread's open traced spans
_registered = False
_trace = None  # the running torch.profiler.profile, if any
_OFF = nullcontext()


def _recording() -> bool:
    """Whether a torch.profiler records in this process (never before
    torch is imported: no profiler can run without it).  Once torch is
    imported this name is rebound to torch's own check, one C call."""
    global _recording
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    _recording = torch._C._autograd._profiler_enabled
    return _recording()


def enabled() -> bool:
    """Whether tracing is on now."""
    return bool(_MODE or _recording())


def spans() -> dict:
    """A copy of the span totals: name -> (total_s, count, self_s)."""
    return {k: tuple(v) for k, v in _spans.items()}


def counters() -> dict:
    """A copy of the counters: name -> value."""
    return dict(_counters)


def _report() -> None:
    global _trace
    if _trace is not None:
        try:
            _trace.stop()
            _trace.export_chrome_trace(os.path.join(
                _MODE, f"ccphylo_tpu_torch.{os.getpid()}.pt.trace.json"))
        except Exception:  # noqa: BLE001 - profiling must never kill a run
            pass
        _trace = None
    if not _spans and not _counters:
        return
    w = sys.stderr
    w.write("# --- ccphylo_tpu_torch profile ---\n")
    for name, (secs, n, own) in _spans.items():
        line = f"# phase {name}: {secs:.3f} s  ({n} x, self {own:.3f} s)"
        rate_key = name + "/items"
        if rate_key in _counters and secs > 0:
            line += f"  ({_counters[rate_key] / secs:,.0f} items/s)"
        w.write(line + "\n")
    for name, val in _counters.items():
        if not name.endswith("/items"):
            w.write(f"# counter {name}: {val:,.0f}\n")
    w.flush()


def _ensure_registered() -> None:
    global _registered, _trace
    if _registered or not _MODE:
        return
    _registered = True
    if _MODE not in ("stderr", "1"):
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(_MODE, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            _trace = profile(activities=acts)
            _trace.start()
        except Exception as exc:  # noqa: BLE001
            _trace = None
            print(f"# profiler trace unavailable: {exc}", file=sys.stderr)
    atexit.register(_report)


class _Span:
    """One span of `phase`: a record_function, totals and a place on the
    thread's stack while tracing is on; the host clock into `into`."""

    __slots__ = ("name", "items", "into", "traced", "rf", "t0", "inner")

    def __init__(self, name, items, into, traced):
        self.name, self.items, self.into = name, items, into
        self.traced = traced

    def __enter__(self):
        if self.traced:
            _ensure_registered()
            import torch
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            stack.append(self)
            self.inner = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.into is not None:
            self.into[self.name.rpartition("/")[2]] = dt
        if self.traced:
            stack = _open.stack
            stack.pop()
            if stack:
                stack[-1].inner += dt
            tot = _spans.setdefault(self.name, [0.0, 0, 0.0])
            tot[0] += dt
            tot[1] += 1
            tot[2] += dt - self.inner
            if self.items is not None:
                k = self.name + "/items"
                _counters[k] = _counters.get(k, 0.0) + self.items
            self.rf.__exit__(*exc)
        return False


def phase(name: str, items: float | None = None, into: dict | None = None):
    """A span named `name` (<area>/<step>) around a `with` block;
    `items` counts the work in it for a rate line.  With `into`, the
    span also stores its host clock seconds as into[<step>], whether
    tracing is on or not."""
    if into is None and not (_MODE or _recording()):
        return _OFF
    return _Span(name, items, into, bool(_MODE or _recording()))


def count(name: str, val: float = 1.0) -> None:
    """Add `val` to the counter `name` while tracing is on."""
    if not (_MODE or _recording()):
        return
    _ensure_registered()
    _counters[name] = _counters.get(name, 0.0) + val
