"""gzip-transparent file IO (reference: filebuff.c:52-117 openAndDetermine).

The reference sniffs the two-byte gzip magic (0x1f 0x8b, little-endian
35615) and routes reads through zlib when present.  We read whole streams
into memory; parsing is index-based rather than buffer-refill based, which
preserves the same observable semantics.
"""

from __future__ import annotations

import gzip
import io
import sys


GZ_MAGIC = b"\x1f\x8b"


def read_bytes(filename: str) -> bytes:
    """Read a possibly-gzipped file (or '-' for stdin) fully into bytes."""
    if filename == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(filename, "rb") as fh:
            data = fh.read()
    if data[:2] == GZ_MAGIC:
        data = gzip.decompress(data)
    return data


def open_out(filename: str):
    """Open an output stream ('-' = stdout) in binary mode."""
    if filename == "-":
        return sys.stdout.buffer
    return open(filename, "wb")


def close_out(fh) -> None:
    if fh is not sys.stdout.buffer:
        fh.close()
    else:
        fh.flush()


def open_out_gz(filename: str, level: int = 1):
    """Gzip-compressed output (reference writeGzFileBuff, filebuff.c:279)."""
    if filename == "-":
        return gzip.GzipFile(fileobj=sys.stdout.buffer, mode="wb", compresslevel=level)
    return gzip.open(filename, "wb", compresslevel=level)


def is_gz_name(filename: str) -> bool:
    return filename.endswith(".gz")
