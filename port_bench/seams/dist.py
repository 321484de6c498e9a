"""The `dist` seam: `cli/dist_cmd.py::_batch_shared`, the call the CLI
makes for `.fsa` input under a shared include mask, on the u64
sequences and the u32 include words the `.fsa` loader hands it.  The
call covers the host conversion, the upload, the expansion and Gram
kernels and the n x n copy back.

Traffic keys: pool (alignments a run cycles through).  Every fill of
the window is compared, cell by cell, with the plain reference's counts
for its alignment; the workload's `check` is how many of the pool's
alignments, drawn from the seed, the reference counts."""

from __future__ import annotations

import torch

from ccphylo_tpu_torch.cli import dist_cmd

from ..gen import collection
from ..reference import snp


class Seam:
    def __init__(self, cfg: dict, traffic: dict, seed: int, dev):
        self.cfg, self.traffic = cfg, traffic
        self.n = cfg["n"]
        self.dev = dev
        self.pool = [collection.alignment(cfg, seed, k, dev)
                     for k in range(traffic["pool"])]
        self.idxs = list(range(self.n))
        # the loader hands one array a sample
        self.rows = [list(seqs) for seqs, _ in self.pool]

    def call(self, k: int):
        out = dist_cmd._batch_shared(self.rows[k], self.idxs, self.pool[k][1])
        return out, {"pairs": self.n * (self.n - 1) // 2}

    def control(self, k: int):
        """The reference in the program's place, its products in
        bfloat16, the precision below its float32."""
        seqs, inc = self.pool[k]
        out = snp.counts(seqs, inc, self.dev, dtype=torch.bfloat16)
        return out, {"pairs": self.n * (self.n - 1) // 2}

    @staticmethod
    def end_to_end(recs: list, window_s: float) -> dict:
        return {"dist_pairs_per_s":
                (sum(r["pairs"] for r in recs) / window_s, "pairs/s")}

    def compare(self, calls: list, sample: list, dev) -> dict:
        wrong = missing = failed = 0
        for k in sample:
            outs = [out for kk, out, _ in calls if kk == k]
            if not outs:
                missing += 1
                continue
            ref = snp.counts(*self.pool[k], dev)
            for out in outs:
                bad = int((out != ref).sum())
                wrong += bad
                failed += bad > 0
        return {"failed": failed,
                "numbers": {"cells_wrong": (wrong, 0),
                            "inputs_unchecked": (missing, 0)},
                "info": {"fills_compared": sum(1 for kk, _, _ in calls
                                               if kk in sample)}}
