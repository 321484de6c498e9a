"""The `tree` seam: `cli/tree_cmd.py::_dispatch_build`, the call the CLI
makes for each matrix it loads, on the lower triangle and the names the
Phylip loader hands it.  The call covers the route, the engine, the
limbs and the Newick bytes; the route it took
(`_dispatch_build.last_engine`) is recorded with each call.

Traffic keys: method, dtype, bytescale (the CLI's -m, -b/-s, -B),
pool (distance matrices a run cycles through), engine (the route the
cell exists for: a call that takes another, such as the host engine
the float route hands a tree that leaves float64's exact range, is
counted in `off_route_calls` and fails the run), cell_bytes (the bytes
of one cell of that route's storage on the card, for the roofline).
Only the joins of calls on that route count as the card's
(`card_joins`).  The workload's `check` is how many of the pool's
matrices, drawn from the seed, the reference rebuilds; every call on
them is compared byte for byte."""

from __future__ import annotations

import numpy as np

from ccphylo_tpu_torch.cli import tree_cmd
from ccphylo_tpu_torch.io.qseqs import Name
from ccphylo_tpu_torch.tree import packed_engine

from ..gen import collection
from ..reference import dnj


class Seam:
    def __init__(self, cfg: dict, traffic: dict, seed: int, dev):
        self.cfg, self.traffic = cfg, traffic
        self.n = cfg["n"]
        self.pool = [collection.distances(cfg, seed, k, dev)
                     for k in range(traffic["pool"])]
        self.names = collection.name_specs(self.n)

    def call(self, k: int):
        t = self.traffic
        out = tree_cmd._dispatch_build(
            self.pool[k], self.n, [Name(d, c) for d, c in self.names],
            t["method"], 0, 9, t["dtype"], t["bytescale"])
        engine = tree_cmd._dispatch_build.last_engine
        joins = self.n - 2
        rec = {"joins": joins, "engine": engine,
               "card_joins": joins if engine == t["engine"] else 0}
        if engine == "packed":
            rec["quantize_s"] = packed_engine.build_tree_packed \
                .last_times["quantize"]
        return out, rec

    def control(self, k: int):
        """The reference in the program's place, one precision below the
        configuration's: float32 for float64 state, 4-bit cells for
        u8 cells."""
        t = self.traffic
        low = dict(qmax=15) if t["dtype"] == "b" else dict(ftype=np.float32)
        out = self._reference(k, **low)
        return out, {"joins": self.n - 2, "engine": t["engine"],
                     "card_joins": self.n - 2}

    def _reference(self, k: int, **low) -> bytes:
        t = self.traffic
        if t["method"] != "dnj":
            raise ValueError("the plain reference builds dnj trees only")
        return dnj.newick(self.pool[k], self.n,
                          [dnj.RefName(d, c) for d, c in self.names],
                          t["dtype"], t["bytescale"], **low)

    @staticmethod
    def end_to_end(recs: list, window_s: float) -> dict:
        secs = [r["s"] for r in recs]
        return {"tree_joins_per_s":
                (sum(r["joins"] for r in recs) / window_s, "joins/s"),
                "tree_s_p95": (float(np.percentile(secs, 95)), "s")}

    def compare(self, calls: list, sample: list, dev) -> dict:
        """calls: (pool index, output, record) of every call."""
        t = self.traffic
        engines: dict = {}
        for _, _, rec in calls:
            engines[rec["engine"]] = engines.get(rec["engine"], 0) + 1
        failed = [rec["engine"] != t["engine"] for _, _, rec in calls]
        off_route = sum(failed)
        wrong = missing = 0
        for k in sample:
            at = [c for c, (kk, _, _) in enumerate(calls) if kk == k]
            if not at:
                missing += 1
                continue
            ref = self._reference(k)
            for c in at:
                if calls[c][1] != ref:
                    wrong += 1
                    failed[c] = True
        return {
            "failed": sum(failed),
            "numbers": {
                "trees_wrong": (wrong, 0),
                "off_route_calls": (off_route, 0),
                "inputs_unchecked": (missing, 0)},
            "info": {"engines": engines,
                     "trees_compared": sum(1 for kk, _, _ in calls
                                           if kk in sample)}}
