"""KMA database readers (.length.b / .seq.b / .name) — reference
seq2fasta.c:29-94, dbparse.c:26.

Counterpart of ccphylo_tpu/io/kmadb.py: the port's own copy."""

from __future__ import annotations

import numpy as np

BASES = b"ACGTN-"


def get_lengths(dbname: str) -> np.ndarray:
    """getLengths (seq2fasta.c:29-48): int32 DB size then per-template
    lengths; slot 0 is overwritten with the DB size."""
    with open(dbname + ".length.b", "rb") as fh:
        db_size = int(np.fromfile(fh, np.int32, 1)[0])
        lengths = np.fromfile(fh, np.int32, db_size)
    lengths[0] = db_size
    return lengths


def read_names(dbname: str) -> list[bytes]:
    """nameLoad over the whole .name file (newline separated)."""
    with open(dbname + ".name", "rb") as fh:
        data = fh.read()
    return data.split(b"\n")


def unpack_seq(words: np.ndarray, length: int) -> bytes:
    """2-bit unpack (getNuc, stdnuc.h:20): base j in the top bits."""
    shifts = (62 - 2 * np.arange(32)).astype(np.uint64)
    codes = ((words[:, None] >> shifts) & np.uint64(3)).reshape(-1)
    lut = np.frombuffer(BASES, np.uint8)
    return lut[codes[:length].astype(np.intp)].tobytes()


def iter_fastas(dbname: str, seqlist=None):
    """Yield (name, sequence_bytes) for templates 1..DB_size-1, or only
    the (1-based) indices in seqlist (printFastas/printFastaList,
    seq2fasta.c:50-170)."""
    lengths = get_lengths(dbname)
    names = read_names(dbname)
    db_size = int(lengths[0])
    want = None
    if seqlist is not None:
        want = sorted(i for i in seqlist if i > 0)
    with open(dbname + ".seq.b", "rb") as fh:
        for i in range(1, db_size):
            nwords = (int(lengths[i]) >> 5) + 1
            words = np.fromfile(fh, np.uint64, nwords)
            if want is not None and i not in want:
                continue
            name = names[i - 1] if i - 1 < len(names) else b""
            yield name, unpack_seq(words, int(lengths[i]))
