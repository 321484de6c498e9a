"""Phylip distance-matrix I/O with byte parity to the reference.

Parity points:
- printing: phy.c:59-123 (printphy), phy.c:125-199 (printfullphy),
  phy.c:201-249 (printphyUpdate)
- loading:  phy.c:251-507 (loadPhy) — multi-matrix streams, optional
  '#'-comment header, relaxed (separator-delimited) names with trailing
  whitespace chomp, lower-triangular OR full-matrix rows (extra columns
  on a row are skipped), empty fields between separators skipped.
- name stripping: phy.c:33-50 (stripDir / noStripDir), quote stripping
  phy.c:98-100.

Values print as "\t%d" when d == (int)d else "\t%.{precision}f"
(default precision 9, phy.c:61).  The matrix size header prints as
"%10d\n".
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from .qseqs import Name
from .. import native

# C isspace set
_WHITESPACE = b" \t\n\r\x0b\x0c"


def _bytes_ptr(data: bytes):
    """Zero-copy uint8* view of a bytes object (immutable, contiguous)."""
    return ctypes.cast(ctypes.c_char_p(data),
                       ctypes.POINTER(ctypes.c_uint8))


class PhylipParseError(Exception):
    pass


class PhylipStream:
    """Sequential reader of (possibly multi-matrix) Phylip streams.

    Mirrors loadPhy's statefulness: name buffers (and their capacity
    growth) persist across matrices in one stream, as the reference
    reuses its Qseqs objects (phy.c:361-379, tree.c:61-66).
    """

    def __init__(self, data: bytes, sep: bytes = b"\t", quotes: bytes = b"\x00",
                 initial_names: int = 32, initial_name_cap: int = 4):
        self.data = data
        self.pos = 0
        self.sep = sep[:1]
        self.quotes = quotes[:1] if quotes != b"\x00" else b""
        # formTree pre-allocates 32 names with capacity 4 (tree.c:61-66);
        # loadPhy extends with capacity-32 names beyond that (phy.c:368,376-378)
        self.names: list[Name] = [Name(b"", initial_name_cap)
                                  for _ in range(initial_names)]
        self._alloc = initial_names

    def _getc(self):
        if self.pos >= len(self.data):
            return None
        c = self.data[self.pos:self.pos + 1]
        self.pos += 1
        return c

    def _read_line(self) -> bytes | None:
        """Bytes up to (excluding) newline; advance past it.  None at EOF."""
        if self.pos >= len(self.data):
            return None
        nl = self.data.find(b"\n", self.pos)
        if nl < 0:
            line = self.data[self.pos:]
            self.pos = len(self.data)
            return line
        line = self.data[self.pos:nl]
        self.pos = nl + 1
        return line

    def load(self, u8_scale: float | None = None):
        """Load the next matrix.

        Returns (n, flat, names, header) where flat is the float64
        lower-triangular cell array in row-major (row i has i cells)
        order, names the Name list (first n valid), header the bytes of a
        leading '#'-comment or None.  Returns None when the stream is
        exhausted (n == 0).

        u8_scale: the ByteScale of a caller that takes -b cells.  Where
        n > 2 and every cell is a number >= 0, flat is then the uint8
        cells as loadPhy -b stores them (`dtouc_cells`), one byte a
        cell; a matrix with a missing cell, and every matrix without
        u8_scale, loads as float64.
        """
        data, sep = self.data, self.sep
        if self.pos >= len(data):
            return None

        header = None
        if data[self.pos:self.pos + 1] == b"#":
            self.pos += 1
            header = self._read_line()
            if header is None:
                return None

        # matrix size: every digit on the line contributes (phy.c:338-351)
        line = self._read_line()
        if line is None:
            return None
        n = 0
        for b in line:
            if 0x30 <= b <= 0x39:
                n = 10 * n + (b - 0x30)
        if n == 0:
            return None

        # extend the name pool like loadPhy's realloc path (phy.c:370-379)
        while self._alloc < n:
            self.names.append(Name(b"", 32))
            self._alloc += 1

        ncells = n * (n - 1) // 2
        quant = u8_scale is not None and n > 2 and math.isfinite(u8_scale) \
            and u8_scale > 0

        # --- native fast path (identical bytes; any parse trouble falls
        # back to the Python loop below, which raises the reference's
        # exact error messages); u8 cells first where asked, then, if a
        # cell refuses them, float64 cells
        nat = native.get_lib()
        if nat is not None and quant:
            cells = np.empty(ncells, dtype=np.uint8)
            if self._load_native(nat, n, cells, u8_scale) is not None:
                return n, cells, self.names, header
        flat = np.empty(ncells, dtype=np.float64)
        if nat is not None:
            res = self._load_native(nat, n, flat)
            if res is not None:
                return n, flat, self.names, header

        cell = 0
        for i in range(n):
            # --- name: chars until sep or newline (inclusive), then chomp
            start = self.pos
            raw_count = 0
            c = b""
            while True:
                c = self._getc()
                if c is None:
                    raise PhylipParseError(
                        f"Malformatted phylip file, name on row: {i + 1}")
                raw_count += 1
                if c == sep or c == b"\n":
                    break
            raw = data[start:start + raw_count]
            name = self.names[i]
            # a leading quote consumes one capacity slot too (phy.c:405-408)
            name.grow_for(raw_count + (1 if self.quotes else 0))
            stripped = raw.rstrip(_WHITESPACE)
            if self.quotes:
                name.data = self.quotes + stripped + self.quotes
            else:
                name.data = stripped

            # --- i distances
            for j in range(i):
                stop = sep if j != i - 1 else b"\n"
                token = b""
                while not token:
                    tstart = self.pos
                    while True:
                        c = self._getc()
                        if c is None:
                            raise PhylipParseError(
                                "Malformatted phylip file, unexpected end of "
                                f"file, distance pos:\t({i},{j})")
                        if c == stop or c == sep:
                            break
                    token = data[tstart:self.pos - 1]
                try:
                    val = float(token)
                except ValueError:
                    raise PhylipParseError(
                        f"Malformatted distance at pos:\t({i},{j})\n"
                        f'"{token.decode(errors="replace")}"')
                flat[cell] = val
                cell += 1

            # skip remainder of the line (full-matrix tolerance, phy.c:489-500)
            while c != b"\n":
                c = self._getc()
                if c is None:
                    if i != n - 1:
                        raise PhylipParseError(
                            f"Malformatted phylip file, missing newline at row:\t{i}")
                    break

        if quant and (flat >= 0).all():
            return n, dtouc_cells(flat, u8_scale), self.names, header
        return n, flat, self.names, header

    def _load_native(self, nat, n: int, flat: np.ndarray, u8_scale=None):
        """Parse the n-row body with the C++ kernel (phy_body, or
        phy_body_u8 into uint8 `flat` at ByteScale u8_scale); returns
        True on success (self.pos advanced, names updated), None to fall
        back (self.pos unchanged)."""
        data = self.data
        pos = ctypes.c_int64(self.pos)
        name_offs = np.empty(2 * n, np.int64)
        raw_lens = np.empty(n, np.int64)
        head = (_bytes_ptr(data), len(data), ctypes.byref(pos), n,
                self.sep[0])
        tail = (name_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                raw_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if flat.dtype == np.uint8:
            status = nat.phy_body_u8(
                *head, float(u8_scale),
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), *tail)
        else:
            status = nat.phy_body(
                *head, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                *tail)
        if status != 0:
            return None
        self.pos = pos.value
        quotes = self.quotes
        extra = 1 if quotes else 0
        for i in range(n):
            name = self.names[i]
            name.grow_for(int(raw_lens[i]) + extra)
            stripped = data[name_offs[2 * i]:name_offs[2 * i + 1]]
            name.data = (quotes + stripped + quotes) if quotes else stripped
        return True


def dtouc_cells(flat, bytescale: float) -> np.ndarray:
    """Distances as loadPhy -b stores them (dtouc(d, 0.5), phy.c:473-475):
    floor(d * bytescale + 0.5), clipped to [0, 255], one uint8 a cell."""
    q = np.floor(np.asarray(flat, np.float64) * bytescale + 0.5)
    return np.clip(q, 0, 255).astype(np.uint8)


def load_phy(data: bytes, sep: bytes = b"\t", quotes: bytes = b"\x00"):
    """Load the first/only matrix from a Phylip byte stream."""
    return PhylipStream(data, sep=sep, quotes=quotes).load()


def strip_dir(name: bytes) -> bytes:
    """phy.c:33 — strip leading directories from an entry name."""
    idx = name.rfind(b"/")
    return name[idx + 1:] if idx >= 0 else name


def no_strip_dir(name: bytes) -> bytes:
    return name


def strip_quotes(name: bytes) -> bytes:
    """phy.c:98-100 — strip a single level of matching quotes."""
    if len(name) >= 2 and ((name[:1] == b'"' and name[-1:] == b'"')
                           or (name[:1] == b"'" and name[-1:] == b"'")):
        return name[1:-1]
    return name


def _fmt_value(d: float, precision: int) -> bytes:
    # phy.c:113-119: ints print as %d, otherwise %.*f
    if d == int(d) and abs(d) < 2**63:
        return b"\t%d" % int(d)
    return ("\t%.*f" % (precision, d)).encode()


def _fmt_cells(vals: np.ndarray, precision: int) -> bytes:
    """Format a run of cells ("\\t%d" / "\\t%.*f" per phy.c:113-119),
    via the native kernel when available."""
    count = len(vals)
    nat = native.get_lib()
    if nat is not None and count:
        vals64 = np.ascontiguousarray(vals, np.float64)
        cap = count * (precision + 360) + 64
        out = ctypes.create_string_buffer(cap)
        w = nat.fmt_cells(
            vals64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            count, precision,
            ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), cap)
        if w >= 0:
            return out.raw[:w]
    return b"".join(_fmt_value(float(d), precision) for d in vals)


def _fmt_name(name: bytes, fmt: int, strip=strip_dir) -> bytes:
    name = strip(strip_quotes(name))
    if fmt & 1:
        return name
    # %-10.10s: truncate to 10, pad right to 10
    return name[:10].ljust(10)


def print_phy(out, n: int, flat, names, fmt: int = 1, precision: int = 9,
              include=None, comment: bytes | None = None,
              strip=strip_dir) -> None:
    """printphy (phy.c:59-123): lower-triangular Phylip writer.

    ``flat`` iterates the n(n-1)/2 cells in row order as floats (already
    de-quantized).  ``include`` optionally masks source rows: rows are
    consumed from names[] until n included rows are printed; the flat
    array must already correspond to included entries only (callers using
    include pass the dense matrix of the included subset, matching the
    reference where exclusion happens before the matrix is built —
    include here only selects which *names* are printed).
    """
    if fmt & 4 and comment is not None:
        out.write(b"#" + comment + b"\n")
    out.write(b"%10d\n" % n)
    flat = np.asarray(flat, dtype=np.float64)
    cell = 0
    printed = 0
    i = 0
    while printed != n:
        if include is None or include[i]:
            out.write(_fmt_name(bytes(names[i]), fmt, strip))
            out.write(_fmt_cells(flat[cell:cell + printed], precision))
            cell += printed
            out.write(b"\n")
            printed += 1
        i += 1


def print_full_phy(out, n: int, flat, names, fmt: int = 1, precision: int = 9,
                   strip=strip_dir) -> None:
    """printfullphy (phy.c:125-199): square Phylip writer from ltd cells."""
    out.write(b"%10d\n" % n)
    flat = np.asarray(flat, dtype=np.float64)

    for i in range(n):
        out.write(_fmt_name(bytes(names[i]), fmt, strip))
        base = i * (i - 1) // 2
        out.write(_fmt_cells(flat[base:base + i], precision))
        out.write(b"\t0")
        if i + 1 < n:
            js = np.arange(i + 1, n, dtype=np.int64)
            out.write(_fmt_cells(flat[js * (js - 1) // 2 + i], precision))
        out.write(b"\n")


def print_phy_update(path: str, n: int, name: bytes, row, fmt: int = 1,
                     precision: int = 9, strip=strip_dir) -> None:
    """printphyUpdate (phy.c:201-249): append one row in place.

    Rewrites the leading size field as "%10d" (after an optional
    '#'-comment line) and appends the new row at the end.
    """
    with open(path, "r+b") as fh:
        first = fh.read(1)
        offset = 0
        if first == b"#":
            line = fh.readline()
            offset = 1 + len(line)
        fh.seek(offset)
        fh.write(b"%10d" % n)
        fh.seek(0, 2)
        fh.write(_fmt_name(bytes(name), fmt, strip)
                 + _fmt_cells(np.asarray(row, np.float64), precision)
                 + b"\n")


def get_size_phy(data: bytes, pos: int = 0):
    """getSizePhy (phy.c:509-562): parse matrix size, return (n, newpos)."""
    if pos >= len(data):
        return 0, pos
    if data[pos:pos + 1] == b"#":
        nl = data.find(b"\n", pos)
        if nl < 0:
            return 0, len(data)
        pos = nl + 1
    nl = data.find(b"\n", pos)
    if nl < 0:
        return 0, len(data)
    n = 0
    for b in data[pos:nl]:
        if 0x30 <= b <= 0x39:
            n = 10 * n + (b - 0x30)
    return n, nl + 1


def get_filenames_phy(data: bytes, pos: int, n: int, path: bytes,
                      sep: bytes = b"\t"):
    """getFilenamesPhy (phy.c:564-649): read the n row names, each
    prefixed with ``path``; returns (names, newpos)."""
    names = []
    for _ in range(n):
        nl = data.find(b"\n", pos)
        line = data[pos:nl] if nl >= 0 else data[pos:]
        sidx = line.find(sep)
        raw = line if sidx < 0 else line[:sidx]
        names.append(path + raw.rstrip(_WHITESPACE))
        pos = (nl + 1) if nl >= 0 else len(data)
    return names, pos
