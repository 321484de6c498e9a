"""KMA file-format parsers: count matrices (.mat), fastas, .res tables,
.union streams.

Parity sources: matparse.c:45-317 (NucCount / MatrixCounts: per-row
counts in file order ``ref A C G T N -`` stored as [A,C,G,T,-,N] with the
N column moved last, matparse.c:251-258), matcmp.c:27-61 (stripMat),
seqparse.c (fasta scanning with translation tables),
resparse.c:50-219 (.res rows), unionparse.c:46-229 (.union entries).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import fileio
from .. import native
from ..ops.pack2bit import translate


class MatTemplate:
    """One template's count matrix.

    counts: (L, 6) uint16 in [A, C, G, T, -, N] order; totals: (L,)
    int64 row sums (all six); refs: length-L uint8 of reference bases.
    """

    __slots__ = ("name", "refs", "counts", "totals")

    def __init__(self, name, refs, counts, totals):
        self.name = name
        self.refs = refs
        self.counts = counts
        self.totals = totals

    @property
    def length(self) -> int:
        return len(self.refs)

    def n_nucs(self, min_depth: int) -> int:
        """#rows with total >= minDepth (FileBuffLoadMat counts all rows
        including insertions, matparse.c:262-264)."""
        return int((self.totals >= min_depth).sum())

    def stripped(self) -> "MatTemplate":
        """stripMat (matcmp.c:27-61): drop insertion rows (ref == '-')."""
        keep = self.refs != ord("-")
        if keep.all():
            return self
        return MatTemplate(self.name, self.refs[keep], self.counts[keep],
                           self.totals[keep])


def _parse_rows_native(block: bytes):
    """Native (C++) row parser; None -> fall back to the Python loop."""
    nat = native.get_lib()
    if nat is None or not block:
        return None
    dptr = ctypes.cast(ctypes.c_char_p(block),
                       ctypes.POINTER(ctypes.c_uint8))
    nrow = nat.mat_count_rows(dptr, len(block), 0)
    if nrow <= 0:
        return None
    refs = np.empty(nrow, np.uint8)
    counts = np.empty((nrow, 6), np.uint16)
    totals = np.empty(nrow, np.int64)
    pos = ctypes.c_int64(0)
    got = nat.mat_rows(
        dptr, len(block), ctypes.byref(pos),
        refs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        totals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nrow)
    if got != nrow:
        return None
    return refs, counts, totals


def _parse_rows(block: bytes):
    """Parse the data rows of one template section."""
    res = _parse_rows_native(block)
    if res is not None:
        return res
    refs = []
    rows = []
    for line in block.split(b"\n"):
        if not line:
            break  # a blank line ends the entry (matparse.c:73-79)
        if line[:1] == b"#":
            break
        parts = line.split(b"\t")
        refs.append(parts[0][0] if parts[0] else ord("-"))
        rows.append([int(x) for x in parts[1:7]])
    if not rows:
        return (np.empty(0, np.uint8), np.empty((0, 6), np.uint16),
                np.empty(0, np.int64))
    arr = np.asarray(rows, np.int64)
    # file order A C G T N - ; storage order A C G T - N (N moved last)
    counts = arr[:, [0, 1, 2, 3, 5, 4]].astype(np.uint16)
    totals = arr.sum(axis=1)
    return np.asarray(refs, np.uint8), counts, totals


def iter_mat_templates(data: bytes):
    """Yield (name, section_bytes) per '#template' block of a .mat."""
    for name, (start, end) in _iter_mat_template_spans(data):
        yield name, data[start:end]


# --- per-file template index cache ------------------------------------------
# The reference avoids re-scanning multi-template .mat streams with
# fbseek TimeStamps (file position + inflate-state checkpoints,
# fbseek.c:27-95; disabled for gz there).  Here: decompressed bytes +
# a name -> byte-span index, cached per (path, mtime, size) with an
# LRU byte budget (CCPHYLO_TORCH_MAT_CACHE_MB, default 1024; 0 disables).

_mat_cache: dict = {}


def _mat_cache_budget() -> int:
    import os
    try:
        mb = int(os.environ.get("CCPHYLO_TORCH_MAT_CACHE_MB", "1024"))
    except ValueError:
        mb = 1024
    return mb * (1 << 20)


def _mat_file_index(filename: str):
    """(data, {template_name: (start, end)}, stable_key|None) for a
    .mat file, cached per (path, mtime, size)."""
    import os
    budget = _mat_cache_budget()
    try:
        st = os.stat(filename)
        key = (filename, st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    if key is not None and key in _mat_cache:
        ent = _mat_cache.pop(key)
        _mat_cache[key] = ent  # LRU refresh
        return ent + (key,)
    data = fileio.read_bytes(filename)
    index = {}
    for name, span in _iter_mat_template_spans(data):
        index.setdefault(name, span)
    ent = (data, index)
    cached = key is not None and budget > 0 and len(data) <= budget
    if cached:
        _mat_cache[key] = ent
        total = sum(len(d) for d, _ in _mat_cache.values())
        while total > budget and len(_mat_cache) > 1:
            oldest = next(iter(_mat_cache))  # dicts keep insert order
            d, _ = _mat_cache.pop(oldest)
            total -= len(d)
    return ent + (key if cached else None,)


def _iter_mat_template_spans(data: bytes):
    """Yield (name, (start, end)) byte spans per '#template' block."""
    pos = 0
    n = len(data)
    while pos < n:
        h = data.find(b"#", pos)
        if h < 0:
            return
        nl = data.find(b"\n", h)
        if nl < 0:
            return
        name = data[h + 1:nl]
        nxt = data.find(b"\n#", nl)
        end = n if nxt < 0 else nxt + 1
        yield name, (nl + 1, end)
        pos = end


_parsed_cache: dict = {}


def _parsed_cache_evict(budget: int) -> None:
    total = sum(e[1].nbytes + e[2].nbytes + e[0].nbytes
                for e in _parsed_cache.values())
    while total > budget and _parsed_cache:
        oldest = next(iter(_parsed_cache))
        e = _parsed_cache.pop(oldest)
        total -= e[1].nbytes + e[2].nbytes + e[0].nbytes


def load_mat_template(filename: str, target: bytes) -> MatTemplate | None:
    """Find one template in a (gzipped) KMA .mat file and parse it.

    Parsed templates are memoized (the reference re-streams the file
    per pair, ltdmatrix.c:85-105, because it keeps only one sample in
    memory; callers here receive shared arrays and must not mutate)."""
    data, index, fkey = _mat_file_index(filename)
    span = index.get(target)
    if span is None:
        return None
    if fkey is None:
        refs, counts, totals = _parse_rows(data[span[0]:span[1]])
        return MatTemplate(target, refs, counts, totals)
    key = (fkey, target)
    hit = _parsed_cache.pop(key, None)
    if hit is None:
        hit = _parse_rows(data[span[0]:span[1]])
    _parsed_cache[key] = hit  # (re)insert = LRU refresh
    _parsed_cache_evict(_mat_cache_budget())
    refs, counts, totals = hit
    return MatTemplate(target, refs, counts, totals)


def mat_template_names(filename: str):
    data = fileio.read_bytes(filename)
    return [name for name, _ in iter_mat_templates(data)]


# --- fasta -----------------------------------------------------------------

_WS = b" \t\n\r\x0b\x0c"


def iter_fasta(data: bytes):
    """Yield (header, raw_sequence_bytes); header chomped like
    FileBuffgetFsaHeader (seqparse.c:128-193)."""
    pos = 0
    n = len(data)
    while pos < n:
        h = data.find(b">", pos)
        if h < 0:
            return
        nl = data.find(b"\n", h)
        if nl < 0:
            return
        header = data[h + 1:nl].rstrip(_WS)
        nxt = data.find(b">", nl)
        end = n if nxt < 0 else nxt
        yield header, data[nl + 1:end]
        pos = end


def load_fasta_seq(data: bytes, target: bytes, table: np.ndarray):
    """Find the target entry and return its translated code array, or
    None when the header is missing (cdist.c:68-78)."""
    for header, raw in iter_fasta(data):
        if header == target:
            return translate(raw, table)
    return None


# --- .res tables (resparse.c) ----------------------------------------------


class ResEntry:
    __slots__ = ("template", "score", "expected", "template_length",
                 "template_identity", "template_coverage", "query_identity",
                 "query_coverage", "depth", "q_value", "p_value")

    def __init__(self, fields):
        self.template = fields[0].rstrip(_WS)
        vals = []
        for f in fields[1:]:
            try:
                vals.append(float(f))
            except ValueError:
                vals.append(0.0)
        vals += [0.0] * (10 - len(vals))
        (self.score, self.expected, self.template_length,
         self.template_identity, self.template_coverage,
         self.query_identity, self.query_coverage, self.depth,
         self.q_value, self.p_value) = vals[:10]


def iter_res(data: bytes):
    """Yield ResEntry per non-header row of a KMA .res table."""
    for line in data.split(b"\n"):
        if not line or line[:1] == b"#":
            continue
        yield ResEntry(line.split(b"\t"))


# --- .union streams (unionparse.c) -----------------------------------------


def parse_union_header(data: bytes):
    """UnionEntry_getHeader (unionparse.c:46-131): first line is
    'N\\tfile1\\t...\\tfileN'.  Returns (filenames, rest_pos)."""
    nl = data.find(b"\n")
    if nl < 0:
        return None, 0
    fields = data[:nl].split(b"\t")
    num = int(fields[0])
    return fields[1:1 + num], nl + 1


def iter_union_entries(data: bytes, pos: int):
    """UnionEntry_get (unionparse.c:133-229): rows of
    'template\\tcount\\tidx...'."""
    for line in data[pos:].split(b"\n"):
        if not line:
            continue
        fields = line.split(b"\t")
        target = fields[0]
        num = int(fields[1])
        idxs = [int(x) for x in fields[2:2 + num]]
        yield target, idxs
