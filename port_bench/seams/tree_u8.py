"""The `tree` seam on u8 cells: `cli/tree_cmd.py::_dispatch_build` on
the lower triangle of uint8 cells that the Phylip loader hands it under
`-b` (`PhylipStream.load(u8_scale=)`: ByteScale applied, one byte a
cell), and the names.  The call covers the route, the packing of the
cells into the engine's words and their upload, the engine, the limbs
and the Newick bytes.  The traffic keys and the comparison are the
`tree` seam's; the pool is `gen/clone_u8.py`'s, the reference
`reference/dnj_u8.py` on the card.

A program whose packed route takes no u8 cells (no
`packed_engine.pack_cells`) would widen every cell to float64 on the
host, 8 bytes a cell: the seam exits with an error before it makes the
pool."""

from __future__ import annotations

import sys
import time

from ccphylo_tpu_torch.cli import tree_cmd
from ccphylo_tpu_torch.io.qseqs import Name
from ccphylo_tpu_torch.tree import packed_engine

from ..gen import clone_u8, collection
from ..reference import dnj_u8
from . import tree


class Seam(tree.Seam):
    def __init__(self, cfg: dict, traffic: dict, seed: int, dev):
        if not hasattr(packed_engine, "pack_cells"):
            sys.exit("tree_u8: this program's packed route takes no u8 "
                     "cells (ccphylo_tpu_torch.tree.packed_engine has no "
                     "pack_cells)")
        self.cfg, self.traffic = cfg, traffic
        self.n = cfg["n"]
        self.dev = dev
        self.pool = [clone_u8.cells(cfg, seed, k, dev)
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
            rec["pack_s"] = packed_engine.build_tree_packed.last_times["pack"]
        return out, rec

    def _reference(self, k: int, qmax: int = 255, **_) -> bytes:
        t = self.traffic
        if t["method"] != "dnj" or t["dtype"] != "b":
            raise ValueError("the u8 reference builds dnj -b trees only")
        return dnj_u8.newick(self.pool[k], self.n,
                             [dnj_u8.RefName(d, c) for d, c in self.names],
                             t["bytescale"], self.dev, qmax=qmax)

    def compare(self, calls: list, sample: list, dev) -> dict:
        t = time.perf_counter()
        judged = super().compare(calls, sample, dev)
        judged["info"]["reference_s"] = time.perf_counter() - t
        return judged
