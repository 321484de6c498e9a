"""The u8 distance matrices of a clonal collection, made on the card.

The clone of `collection.py`: the first isolate is the ancestor and
every later one descends from a random earlier isolate with
Poisson(`subst_per_generation`) substitutions.  Under infinite sites
(no position is hit twice, none is masked) the SNP distance of two
isolates is the length of the path between them in that transmission
tree, each edge weighing its isolate's substitutions.

`cells` gives what the Phylip loader hands `tree -m dnj -b` at ByteScale
1: the lower triangle, row by row, of those distances as uint8 cells,
with no float64 triangle anywhere.  The full symmetric matrix is built
on the device a depth of the tree at a time: the row of isolate i is
its parent's row plus its own weight w_i, less 2 w_i at the isolates of
its own subtree (preorder intervals).  It is then copied out a block of
rows at a time.  Set-up fails if a distance exceeds the configuration's
`max_cell`.
"""

from __future__ import annotations

import numpy as np
import torch

from .collection import stream_seed

_ROWS = 1024    # rows computed, and copied out, at a time


def events(cfg: dict, seed: int, index: int, dev):
    """(parent, w) as lists: each isolate's parent (-1: the ancestor)
    and its number of substitutions, from (seed, index)."""
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, "clone_u8", index))
    n = cfg["n"]
    r = torch.arange(n, device=dev)
    parent = (torch.rand(n, device=dev, generator=g) * r).long()
    parent[0] = -1
    w = torch.poisson(torch.full((n,), float(cfg["subst_per_generation"]),
                                 device=dev), generator=g).long()
    w[0] = 0
    return parent.tolist(), w.tolist()


def _layout(parent: list, w: list):
    """depth in edges, weighted depth, preorder number and subtree size
    of each isolate (parents come before their children)."""
    n = len(parent)
    depth, wd, size = [0] * n, [0] * n, [1] * n
    for i in range(1, n):
        depth[i] = depth[parent[i]] + 1
        wd[i] = wd[parent[i]] + w[i]
    for i in range(n - 1, 0, -1):
        size[parent[i]] += size[i]
    tin, nxt = [0] * n, [1] + [0] * (n - 1)
    for i in range(1, n):
        p = parent[i]
        tin[i] = nxt[p]
        nxt[p] += size[i]
        nxt[i] = tin[i] + 1
    return depth, wd, tin, size


def square(cfg: dict, seed: int, index: int, dev) -> torch.Tensor:
    """The (n, n) uint8 distance matrix of pool entry `index` on `dev`."""
    parent, w = events(cfg, seed, index, dev)
    n = cfg["n"]
    depth, wd, tin, size = _layout(parent, w)
    S = torch.empty((n, n), dtype=torch.uint8, device=dev)
    hi = torch.tensor(max(wd), device=dev)
    S[0] = torch.tensor(wd, device=dev).clamp(max=255).to(torch.uint8)
    par = torch.tensor(parent, device=dev)
    wt = torch.tensor(w, dtype=torch.int16, device=dev)
    t = torch.tensor(tin, dtype=torch.int32, device=dev)
    end = t + torch.tensor(size, dtype=torch.int32, device=dev)
    levels: dict = {}
    for i in range(1, n):
        levels.setdefault(depth[i], []).append(i)
    for d in sorted(levels):
        nodes = torch.tensor(levels[d], device=dev)
        for a in range(0, len(nodes), _ROWS):
            rows = nodes[a:a + _ROWS]
            inside = (t[None, :] >= t[rows, None]) \
                & (t[None, :] < end[rows, None])
            sign = 1 - 2 * inside.to(torch.int16)
            v = S[par[rows]].to(torch.int16) + wt[rows, None] * sign
            hi = torch.maximum(hi, v.max())
            S[rows] = v.clamp(0, 255).to(torch.uint8)
    top = int(hi)
    if top > cfg["max_cell"]:
        raise ValueError(f"a distance of {top} exceeds the largest cell "
                         f"{cfg['max_cell']}")
    return S


def cells(cfg: dict, seed: int, index: int, dev) -> np.ndarray:
    """The lower triangle (row i: cells (i, 0..i-1)) of pool entry
    `index`'s distances, uint8, on the host."""
    S = square(cfg, seed, index, dev)
    n = cfg["n"]
    out = np.empty(n * (n - 1) // 2, np.uint8)
    for r0 in range(0, n, _ROWS):
        r1 = min(r0 + _ROWS, n)
        ar = torch.arange(r1, device=dev)
        blk = torch.masked_select(S[r0:r1, :r1],
                                  ar[None, :] < ar[r0:r1, None])
        torch.from_numpy(out[r0 * (r0 - 1) // 2:r1 * (r1 - 1) // 2]) \
            .copy_(blk)
    return out
