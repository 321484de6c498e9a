"""One run of one cell: set-up, the measured window, the reading of the
trace, the check against the plain reference, and the result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s, from the start of the process): importing
torch and the program, making the cell's pool of inputs from the seed
on the card, and one warm call on the pool's first input, which loads
(or, in a fresh checkout, builds) every kernel the seam runs.  The
window then calls the seam in a closed loop, one call after another,
cycling through the pool, and closes with the first call that ends
`--seconds` after the first began (and not before each input of the
pool has had its call); its rates are all the work of its calls over
all of its time.  With --trace 1 the whole window runs under
torch.profiler and the line carries the per-layer metrics instead.
After the window: the peak memory is read, the program's modules are
checked for JAX, the device's cache is freed, and the seam compares
what the calls returned with the plain reference.

--control 1 (never passed by a check) puts the seam's control, the
reference one precision lower, in the program's place, one call on each
input the reference checks, and compares as a run does: it must come
out not correct.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from . import registry, trace

# modules a run must never load, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "ccphylo_tpu", "benchmarks")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _say(*a) -> None:
    print("#", *a, file=sys.stderr, flush=True)


def _card_line() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"


def _args(argv):
    p = argparse.ArgumentParser(prog="port_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def main(argv, t0: float, *, root: str = registry.HERE, dev=None) -> int:
    """`dev` None: the chip run (exits 2 without the cards the cell
    asks for, and with no CCPHYLO_TORCH_* variable, so the program's
    defaults run); a torch.device: that device, for tests."""
    args = _args(argv)
    wl, cfg, traffic = registry.cell(args.workload, root)
    chips = int(wl.get("chips", 1))
    if dev is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            _say(f"{args.workload} needs {chips} CUDA device(s); "
                 f"torch sees {torch.cuda.device_count()}")
            return 2
        for k in [k for k in os.environ if k.startswith("CCPHYLO_TORCH_")]:
            del os.environ[k]
        dev = torch.device("cuda", 0)
        _say("card:", _card_line())
    cuda = dev.type == "cuda"
    seam = registry.seam(traffic["seam"])(cfg, traffic, args.seed, dev)
    pool = traffic["pool"]
    sample = sorted(random.Random(args.seed).sample(
        range(pool), min(int(wl["check"]), pool)))
    calls = []
    traced = args.trace and not args.control

    if args.control:
        for k in sample:
            out, rec = seam.control(k)
            calls.append((k, out, rec))
    else:
        seam.call(0)
        _sync(cuda)
        setup_s = time.perf_counter() - t0

        def window() -> float:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            _sync(cuda)
            start = time.perf_counter()
            c = 0
            while True:
                k = c % pool
                with torch.profiler.record_function(trace.CALL):
                    a = time.perf_counter()
                    out, rec = seam.call(k)
                    _sync(cuda)
                    b = time.perf_counter()
                rec["s"] = b - a
                calls.append((k, out, rec))
                c += 1
                if b - start >= args.seconds and c >= pool:
                    return b - start

        if traced:
            window_s, events = trace.profiled(window, cuda)
            red = trace.reduce(events)
        else:
            window_s = window()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_loaded()
    if bad:
        _say("the run loaded modules it must not:", ", ".join(bad))
        return 3
    recs = [r for _, _, r in calls]

    metrics = {}
    if traced:
        with open(os.path.join(root, "roofline", "peaks.json")) as fh:
            peaks = json.load(fh)
        ctx = SimpleNamespace(cfg=cfg, traffic=traffic, workload=wl,
                              calls=recs, device=red["device"],
                              window_s=red["window_s"],
                              busy_s=red["busy_s"], peaks=peaks)
        for name, read in registry.readers(root).items():
            got = read(ctx)
            if got is not None:
                metrics[name] = {"value": got[0], "unit": got[1]}
    elif not args.control:
        for k, (v, unit) in seam.end_to_end(recs, window_s).items():
            metrics[k] = {"value": v, "unit": unit}
        metrics["peak_device_gib"] = {"value": peak / 2 ** 30, "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    keep = registry.declared(args.workload, root)
    if keep is not None:
        metrics = {k: v for k, v in metrics.items() if k in keep}
    if cuda:
        torch.cuda.empty_cache()
    judged = seam.compare(calls, sample, dev)
    numbers = judged["numbers"]
    correct = all(v <= lim for v, lim in numbers.values())
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(calls),
              "failed": judged["failed"], "metrics": metrics,
              "device": device}
    if traced:
        device["busy_s"] = red["busy_s"]
        device["window_s"] = red["window_s"]
        result["breakdown"] = red["breakdown"]
    result["info"] = judged["info"]
    if recs and "s" in recs[0]:
        secs = sorted(r["s"] for r in recs)
        result["info"]["call_s"] = [secs[0], secs[len(secs) // 2], secs[-1]]
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in numbers.items()}
    for k, v in judged["info"].items():
        _say(f"{k}: {v}")
    for k, (v, lim) in numbers.items():
        print(f"compared {k} {v} limit {lim}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
