"""Block-wise checkpoint/resume for all-pairs distance fills.

The reference's only resume mechanisms are row-append
(`printphyUpdate`, phy.c:201-249 — kept as `dist -a`) and stream seek
checkpoints (fbseek.c).  For this build the expensive artifact is
the O(n² L) pairwise fill itself, so we checkpoint it directly: the
lower-triangular (block-row, block-col) tile grid of the distance
matrix is computed tile by tile, each finished tile persisted
atomically; a restart recomputes only missing tiles.

Enable on `dist` (fasta shared-mask path) with
CCPHYLO_TORCH_DIST_CKPT=<dir>.  The store keys tiles on a content fingerprint
of the packed inputs, so a changed input set never resumes from stale
tiles.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np


class BlockCheckpoint:
    """Persistent lower-triangular tile store for an (n, n) int matrix.

    compute(bi, bj) -> np.ndarray tile of shape
    (rows(bi), rows(bj)); tiles with bi == bj are lower-triangular
    self-blocks.  Values are stored as .npy, one file per tile, with a
    manifest carrying the fingerprint.
    """

    def __init__(self, directory: str, n: int, fingerprint: str,
                 block: int = 1024, name: str = "D"):
        self.dir = directory
        self.n = n
        self.block = block
        self.name = name
        self.fp = fingerprint
        self.nblocks = -(-n // block)
        os.makedirs(directory, exist_ok=True)
        self.manifest_path = os.path.join(directory,
                                          f"{name}.manifest.json")
        self.manifest = self._load_manifest()

    def _load_manifest(self):
        try:
            with open(self.manifest_path) as fh:
                m = json.load(fh)
            if m.get("fingerprint") == self.fp and m.get("n") == self.n \
                    and m.get("block") == self.block:
                return m
        except (OSError, ValueError):
            pass
        return {"fingerprint": self.fp, "n": self.n, "block": self.block,
                "done": []}

    def _save_manifest(self):
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.manifest, fh)
        os.replace(tmp, self.manifest_path)

    def _tile_path(self, bi: int, bj: int) -> str:
        return os.path.join(self.dir, f"{self.name}_{bi}_{bj}.npy")

    def rows(self, b: int) -> slice:
        return slice(b * self.block, min((b + 1) * self.block, self.n))

    def fill(self, compute) -> np.ndarray:
        """Assemble the full (n, n) matrix, computing missing tiles.

        compute(islice, jslice) returns the tile values (diagonal
        blocks may include garbage above the diagonal; it is zeroed).
        """
        done = set(tuple(x) for x in self.manifest["done"])
        out = np.zeros((self.n, self.n), np.int64)
        for bi in range(self.nblocks):
            for bj in range(bi + 1):
                si, sj = self.rows(bi), self.rows(bj)
                path = self._tile_path(bi, bj)
                if (bi, bj) in done and os.path.exists(path):
                    tile = np.load(path)
                else:
                    tile = np.asarray(compute(si, sj), np.int64)
                    if bi == bj:
                        tile = np.tril(tile, -1)
                    tmp = path + ".tmp.npy"
                    np.save(tmp, tile)
                    os.replace(tmp, path)
                    self.manifest["done"].append([bi, bj])
                    self._save_manifest()
                out[si, sj] = tile
        iu = np.triu_indices(self.n, 1)
        out[iu] = out.T[iu]
        return out


def fingerprint_arrays(arrays) -> str:
    """Stable content hash of a sequence of numpy arrays."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:24]
