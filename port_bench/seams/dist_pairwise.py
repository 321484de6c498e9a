"""The `dist` seam under per-sample include masks:
`cli/dist_cmd.py::_batch_pairwise`, the call the CLI makes for `.fsa`
input with `-f 2` (pair masks) and `-P 0` (no proximity pruning), on the
u64 sequences and each sample's u32 include words the loader hands it.
The call covers the stacking of samples and masks, the pair masks made
on the host, the upload, the expansion and the two Gram products (SNPs
and shared positions) and both n x n copies back.

The sequences are the shared-mask cell's (`collection.alignment`).  Each
sample's include mask is the shared mask less its own uncalled runs, the
way KMA consensus sequences carry per-isolate `n` stretches: traffic
keys `uncalled_runs` (runs a sample) and `uncalled_pct` (the share of
the genome they cover, before overlaps), run lengths uniform in
1 .. 2 L pct / 100 / runs - 1, starts uniform, all drawn from the seed on
the card.

Traffic keys also: pool (alignments a run cycles through).  Every fill
of the window on a checked alignment is compared, cell by cell, with the
plain reference's SNP counts and shared-position counts; the workload's
`check` is how many of the pool's alignments, drawn from the seed, the
reference counts."""

from __future__ import annotations

import numpy as np
import torch

from ccphylo_tpu_torch.cli import dist_cmd

from ..gen import collection
from ..reference import snp_pairwise

_ROWS = 32      # samples whose masks are made at a time


def sample_masks(cfg: dict, traffic: dict, seed: int, index: int,
                 shared: np.ndarray, dev) -> np.ndarray:
    """(n, W) u32 include words: the shared words `shared` less each
    sample's own uncalled runs."""
    g = torch.Generator(device=dev)
    g.manual_seed(collection.stream_seed(seed, "uncalled", index))
    n, L = cfg["n"], cfg["genome_bp"]
    W = shared.shape[0]
    runs = int(traffic["uncalled_runs"])
    mean = L * traffic["uncalled_pct"] / 100.0 / runs
    sh = torch.arange(31, -1, -1, dtype=torch.int64, device=dev)
    keep = ((torch.from_numpy(shared.astype(np.int64)).to(dev)[:, None]
             >> sh) & 1).bool().reshape(-1)
    out = np.empty((n, W), np.uint32)
    for r0 in range(0, n, _ROWS):
        b = min(_ROWS, n - r0)
        start = torch.randint(0, L, (b, runs), device=dev, generator=g)
        length = torch.randint(1, max(2, int(2 * mean)), (b, runs),
                               device=dev, generator=g)
        edge = torch.zeros((b, 32 * W + 1), dtype=torch.int32, device=dev)
        one = torch.ones_like(start, dtype=torch.int32)
        edge.scatter_add_(1, start, one)
        edge.scatter_add_(1, (start + length).clamp(max=32 * W), -one)
        called = edge.cumsum(1, dtype=torch.int32)[:, :32 * W] == 0
        bits = (called & keep).view(b, W, 32).long()
        words = (bits << sh).sum(-1)
        out[r0:r0 + b] = words.cpu().numpy().astype(np.uint32)
    return out


class Seam:
    def __init__(self, cfg: dict, traffic: dict, seed: int, dev):
        self.cfg, self.traffic = cfg, traffic
        self.n = cfg["n"]
        self.dev = dev
        self.pool = []
        for k in range(traffic["pool"]):
            seqs, shared = collection.alignment(cfg, seed, k, dev)
            self.pool.append((seqs, sample_masks(cfg, traffic, seed, k,
                                                 shared, dev)))
        self.idxs = list(range(self.n))
        # the loader hands one array a sample, and one mask a sample
        self.rows = [(list(seqs), list(incs)) for seqs, incs in self.pool]

    def _rec(self) -> dict:
        return {"pairs": self.n * (self.n - 1) // 2, "masks": "per-sample"}

    def call(self, k: int):
        seqs, incs = self.rows[k]
        return dist_cmd._batch_pairwise(seqs, incs, self.idxs), self._rec()

    def control(self, k: int):
        """The reference in the program's place, its products in
        bfloat16, the precision below its float32."""
        return snp_pairwise.counts(*self.pool[k], self.dev,
                                   dtype=torch.bfloat16), self._rec()

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
            ref = snp_pairwise.counts(*self.pool[k], dev)
            for out in outs:
                bad = sum(int((o != r).sum()) for o, r in zip(out, ref))
                wrong += bad
                failed += bad > 0
        return {"failed": failed,
                "numbers": {"cells_wrong": (wrong, 0),
                            "inputs_unchecked": (missing, 0)},
                "info": {"fills_compared": sum(1 for kk, _, _ in calls
                                               if kk in sample)}}
