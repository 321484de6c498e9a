"""The benchmark's one generator of isolate collections.

A clonal collection of n isolates typed against one reference genome of
L bases: the first isolate is the ancestor and every later one descends
from a random earlier isolate with Poisson(`subst_per_generation`)
substitutions, each a shift of the base by the isolate's own offset
1-3.  A shared include mask drops about `mask_excluded_pct` percent of
the positions.  This is the outbreak model of the repository's smoke
script (`outbreak`, `pack2`, `host_u64`, `host_inc32`), frozen here.

Everything is drawn from one torch.Generator on the given device, seeded
from (seed, stream, index), so one seed gives the same inputs.

- `alignment` gives what the `.fsa` loader hands `dist`: the 2-bit
  sequences as (n, W) u64 words (position k of a word at bits 62-2k and
  63-2k) and the shared include mask as (W,) u32 words (position k at
  bit 31-k), W = ceil(L / 32), the tail past L excluded.
- `distances` gives what the Phylip loader hands `tree`: the lower
  triangle, row by row, of the isolates' SNP distances under the mask,
  as float64.  It computes them on the positions that some substitution
  touched (every other position is the ancestor's in every isolate),
  one-hot per base, with integer Gram products.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def stream_seed(seed: int, stream: str, index: int) -> int:
    """A 63-bit seed for one pool entry of one run."""
    h = hashlib.sha256(f"{seed}:{stream}:{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _events(cfg: dict, g: torch.Generator, dev):
    """The substitutions: each isolate's parent (-1: the ancestor), its
    number of substitutions, their positions and its base offset."""
    n, L = cfg["n"], cfg["genome_bp"]
    r = torch.arange(n, device=dev)
    parent = (torch.rand(n, device=dev, generator=g) * r).long()
    parent[0] = -1
    nmut = torch.poisson(torch.full((n,), float(cfg["subst_per_generation"]),
                                    device=dev), generator=g).long()
    nmut[0] = 0
    pos = torch.randint(0, L, (int(nmut.sum()),), device=dev, generator=g)
    delta = torch.randint(1, 4, (n,), device=dev, generator=g,
                          dtype=torch.uint8)
    return parent, nmut, pos, delta


def _bases(cfg: dict, seed: int, stream: str, index: int, dev,
           full: bool):
    """(X, keep): the isolates' bases (n, C) uint8 at C columns and the
    columns the mask keeps.  full: every position of the padded genome;
    else only the positions some substitution touched."""
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, stream, index))
    n, L = cfg["n"], cfg["genome_bp"]
    parent, nmut, pos, delta = _events(cfg, g, dev)
    if full:
        C = -(-L // 32) * 32
        col = pos
    else:
        cols, col = torch.unique(pos, return_inverse=True)
        C = int(cols.numel())
    anc = torch.randint(0, 4, (C,), dtype=torch.uint8, device=dev,
                        generator=g)
    keep = torch.randint(0, 10_000, (C,), device=dev, generator=g) \
        >= int(round(cfg["mask_excluded_pct"] * 100))
    if full:
        anc[L:] = 0
        keep[L:] = False
    X = torch.empty((n, C), dtype=torch.uint8, device=dev)
    X[0] = anc
    par = parent.tolist()
    offs = [0] + torch.cumsum(nmut, 0).tolist()
    dl = delta.tolist()
    for i in range(1, n):
        X[i] = X[par[i]]
        p = col[offs[i]:offs[i + 1]]
        if p.numel():
            X[i, p] = (X[i, p] + dl[i]) % 4
    return X, keep


_SHIFTS = (torch.arange(16, dtype=torch.int64) * -2 + 30)


def pack2(vals: torch.Tensor) -> torch.Tensor:
    """(rows, L) values < 4 -> (rows, L/16) int32 words, position k of a
    word at bits (30-2k, 31-2k)."""
    r, L = vals.shape
    v = (vals.view(r, L // 16, 16).long()
         << _SHIFTS.to(vals.device)).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def host_u64(seqs32: torch.Tensor) -> np.ndarray:
    """(n, 2W) int32 words -> (n, W) u64 words, the loader's layout: the
    even word in the high half.  Formed on the device, then copied."""
    hi = seqs32[:, 0::2].long() << 32
    lo = seqs32[:, 1::2].long() & 0xFFFFFFFF
    return (hi | lo).cpu().numpy().view(np.uint64)


def host_inc32(inc: torch.Tensor) -> np.ndarray:
    """(.., L) bool -> (.., L/32) u32 include words, position k of a word
    at bit 31-k."""
    b = np.packbits(inc.cpu().numpy(), axis=-1, bitorder="big")
    return b.view(">u4").astype(np.uint32)


def alignment(cfg: dict, seed: int, index: int, dev):
    """(seqs (n, W) u64, shared include words (W,) u32) of pool entry
    `index`, as the `.fsa` loader hands them to `dist`."""
    X, keep = _bases(cfg, seed, "alignment", index, dev, full=True)
    rows = max(1, (1 << 27) // X.shape[1])
    words = torch.cat([pack2(X[r:r + rows]) for r in range(0, X.shape[0],
                                                           rows)])
    del X
    return host_u64(words), host_inc32(keep)


def gram_equal(X: torch.Tensor, keep: torch.Tensor,
               chunk: int = 32768) -> torch.Tensor:
    """(n, n) int32: the kept columns at which two isolates have the
    same base, as sums of integer products of one-hot columns."""
    n, C = X.shape
    rows = (-n) % 8          # torch._int_mm takes multiples of 8
    E = torch.zeros((n + rows, n + rows), dtype=torch.int32, device=X.device)
    for c0 in range(0, C, chunk):
        x = X[:, c0:c0 + chunk]
        k = keep[c0:c0 + chunk]
        pad = (-x.shape[1]) % 8
        for b in range(4):
            o = torch.nn.functional.pad(((x == b) & k).to(torch.int8),
                                        (0, pad, 0, rows))
            if X.is_cuda:
                E += torch._int_mm(o, o.t())
            else:
                E += (o.double() @ o.double().t()).to(torch.int32)
    return E[:n, :n]


def distances(cfg: dict, seed: int, index: int, dev) -> np.ndarray:
    """The lower triangle (row i: cells (i, 0..i-1)) of pool entry
    `index`'s SNP distances, float64, as the Phylip loader hands them."""
    X, keep = _bases(cfg, seed, "distances", index, dev, full=False)
    D = int(keep.sum()) - gram_equal(X, keep)
    n = cfg["n"]
    iu = torch.tril_indices(n, n, -1, device=dev)
    return D[iu[0], iu[1]].double().cpu().numpy()


def name_specs(n: int) -> list:
    """(name, buffer capacity) of each taxon as the Phylip loader leaves
    them for a file's first matrix: 32 buffers of 4 bytes, then 32, each
    doubled as the name and its separator are copied in."""
    out = []
    for i in range(n):
        name = b"iso%05d" % i
        cap = 4 if i < 32 else 32
        left = cap
        for _ in range(len(name) + 1):
            left -= 1
            if left == 0:
                left = cap
                cap <<= 1
        out.append((name, cap))
    return out
