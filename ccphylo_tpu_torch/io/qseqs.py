"""Growable byte-string with capacity tracking (reference qseqs.c).

The reference's Newick assembly swaps operands by *buffer capacity*
(nwck.c:45-50 "move largest qseq down"), so byte-parity of tree output
requires reproducing the exact capacity growth of every name buffer:

- setQseqs(sz): capacity sz (qseqs.c:24)
- loadPhy name reads: one char at a time; when the remaining-capacity
  counter hits zero it resets to the *old* capacity and the capacity
  doubles (phy.c:420-428)
- formNode/formLastNode: capacity = max(cap, len1 + len2 + 32) computed
  from pre-merge lengths (nwck.c:53-59)
"""

from __future__ import annotations


class Name:
    __slots__ = ("data", "cap")

    def __init__(self, data: bytes = b"", cap: int = 32):
        self.data = data
        self.cap = cap

    def __bytes__(self) -> bytes:
        return self.data

    def __len__(self) -> int:
        return len(self.data)

    def __repr__(self) -> str:
        return f"Name({self.data!r}, cap={self.cap})"

    def grow_for(self, nchars: int) -> None:
        """Simulate copying nchars bytes one-by-one (phy.c:409-429)."""
        remaining = self.cap
        for _ in range(nchars):
            remaining -= 1
            if remaining == 0:
                remaining = self.cap
                self.cap <<= 1
