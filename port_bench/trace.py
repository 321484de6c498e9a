"""The traced run's reading: torch.profiler (CPU and CUDA activities)
over the whole window, reduced to the device's events inside it, the
seconds in which one ran, the window's length, and the breakdown of
device time by operation and of idle time by what the host was doing
(the innermost host span or operation of the harness's thread)."""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch

WINDOW = "port_bench.window"
CALL = "port_bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def profiled(fn, cuda: bool):
    """Run fn() under the profiler inside a span WINDOW; returns
    (fn's result, the trace's events)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return out, events


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace wrappers and
    arguments, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:96]


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list) -> dict:
    """window_s, busy_s, `device` [(name, cat, ts_us, dur_us)] inside
    the window, and `breakdown` (device_ops, idle_gaps: the 10 largest
    [name, seconds] each)."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = next(e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW)
    ws, we = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    device = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a, d = float(e["ts"]), float(e["dur"])
            if a + d > ws and a < we:
                device.append((e["name"], e["cat"], a, d))
    busy = _merge([(max(a, ws), min(a + d, we)) for _, _, a, d in device])
    busy_us = sum(b - a for a, b in busy)
    ops: dict = {}
    for name, _, _, d in device:
        key = _short(name)
        ops[key] = ops.get(key, 0.0) + d * 1e-6
    # by start, the outer of two that start together first: the last
    # one that starts before an instant and is still open is the innermost
    host = sorted(((float(e["ts"]), -float(e["dur"]), e["name"]) for e in xs
                  if e.get("cat") in HOST_CATS
                  and e.get("tid") == win.get("tid")
                  and e.get("pid") == win.get("pid")))
    starts = [h[0] for h in host]
    gaps: dict = {}
    edges = [ws] + [x for ab in busy for x in ab] + [we]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        t = (a + b) / 2
        name = WINDOW
        k = bisect.bisect_right(starts, t) - 1
        for h in range(k, max(k - 5000, -1), -1):
            if host[h][0] - host[h][1] > t:
                name = host[h][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:10]
    return {"window_s": (we - ws) * 1e-6, "busy_s": busy_us * 1e-6,
            "device": device,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(gaps)}}


def idle_pct(ctx):
    """A per-layer reader: the share of the traced window in which no
    kernel, copy or memset ran on the card."""
    if not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s), "%"
