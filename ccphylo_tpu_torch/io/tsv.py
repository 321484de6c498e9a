"""tsv -> dense matrix loading (reference tsv.c:30-152 loadTsv).

The first line is always treated as a header; additional leading lines
starting with '#' are skipped too.  The column count comes from the
LAST skipped header line.  Values load into the selected dtype
(quantized via dtouc(v, 0.5) for s/b).

Counterpart of ccphylo_tpu/io/tsv.py: the port's own copy."""

from __future__ import annotations

import numpy as np


class Dat:
    """Dense M x N matrix with the reference's dtype semantics
    (dat.c:31-107)."""

    NPD = {"d": np.float64, "f": np.float32, "s": np.uint16,
           "b": np.uint8}

    def __init__(self, vals64: np.ndarray, dtype: str = "d",
                 bytescale: float = 1.0):
        self.dtype = dtype
        self.bs = bytescale
        if dtype in ("s", "b"):
            self.mat = (vals64 * bytescale + 0.5).astype(self.NPD[dtype])
        else:
            self.mat = vals64.astype(self.NPD[dtype])

    @property
    def m(self):
        return self.mat.shape[0]

    @property
    def n(self):
        return self.mat.shape[1]

    def logical(self):
        if self.dtype in ("s", "b"):
            return self.mat.astype(np.float64) / self.bs
        return self.mat.astype(np.float64)


def load_tsv(data: bytes, sep: bytes = b"\t", dtype: str = "d",
             bytescale: float = 1.0) -> Dat | None:
    lines = data.split(b"\n")
    if data.endswith(b"\n"):
        lines = lines[:-1]
    if not lines:
        return None
    # skip the header line, plus following '#' lines (tsv.c:52-71)
    k = 1
    ncols = lines[0].count(sep) + 1
    while k < len(lines) and lines[k][:1] == b"#":
        ncols = lines[k].count(sep) + 1
        k += 1
    rows = []
    for m, line in enumerate(lines[k:]):
        parts = line.split(sep)
        if len(parts) != ncols:
            raise SystemExit(
                f"Malformatted entry at pos:\t({m},{len(parts)})")
        try:
            rows.append([float(x) for x in parts])
        except ValueError as exc:
            raise SystemExit(f"Malformatted entry at pos:\t({m},?) "
                             f"{exc}")
    if not rows:
        return None
    return Dat(np.asarray(rows, np.float64), dtype, bytescale)
