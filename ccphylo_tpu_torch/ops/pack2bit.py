"""2-bit sequence packing and include-position masks.

Parity sources:
- translation tables: fsacmp.c:32-91 (get2BitTable), fsacmp.c:93-162
  (getIupacBitTable)
- packing: qseqs.c:60-88 (qseq2nibble) — 32 bases per u64, first base of
  each block in the highest bit pair, N (code 4) packs as 00 and counts.
- include masks: fsacmp.c:164-179 (initIncPos) — one bit per position,
  MSB-first within u32 words, tail bits zeroed.
- mask derivation + proximity pruning: fsacmp.c:181-353 (getIncPos /
  getIncPosInsig / getIncPosInsigPrune).  The sequential lastSNP-chain is
  reformulated as consecutive-event span masking (equivalent, validated
  against the oracle); the reference's out-of-bounds write for an event
  within the first `proxi` positions (include[-1], fsacmp.c:215-218) is
  clamped to position 0.
- methylation masking: meth.c:70-166 (matchMotif/maskMotif[s]) — the
  bitwise variant matcher reduces to per-position IUPAC set membership
  on the packed codes (N packs as A); capital-letter motif positions are
  masked at every match site, forward and reverse-complement motifs both
  searched (methparse.c:262-286).
"""

from __future__ import annotations

import numpy as np

U32 = np.uint32
U64 = np.uint64


def get_2bit_table(flag: int) -> np.ndarray:
    """get2BitTable (fsacmp.c:32-91): byte -> 2-bit code; 4 = unknown;
    32 = skip.  Lowercase significant iff flag & 8."""
    t = np.full(256, 32, np.uint8)
    for ch, v in zip(b"ACGTUN-", (0, 1, 2, 3, 3, 4, 4)):
        t[ch] = v
    if flag & 8:
        for ch, v in zip(b"acgtun", (0, 1, 2, 3, 3, 4)):
            t[ch] = v
    else:
        t[np.frombuffer(b"acgtun", np.uint8)] = 4
    t[np.frombuffer(b"RYSWKMBDHVX", np.uint8)] = 4
    t[np.frombuffer(b"ryswkmbdhvx", np.uint8)] = 4
    return t


def get_iupac_bit_table(flag: int) -> np.ndarray:
    """getIupacBitTable (fsacmp.c:93-162): 4-bit IUPAC codes for trim;
    lowercase marked with |16 unless flag & 1."""
    t = np.full(256, 32, np.uint8)
    codes = dict(zip("ACGTUN-RYSWKMBDHVX",
                     (0, 1, 2, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13,
                      14, 15, 4)))
    for ch, v in codes.items():
        t[ord(ch)] = v
    for ch, v in codes.items():
        lo = ch.lower()
        if lo == ch:
            continue
        if flag & 1:
            t[ord(lo)] = 4
        elif lo in "nx-":
            t[ord(lo)] = 4
        else:
            t[ord(lo)] = v | 16
    t[ord("x")] = 4
    t[ord("-")] = 5
    return t


def translate(raw: bytes, table: np.ndarray) -> np.ndarray:
    """Translate fasta bytes through a table, dropping skip codes (>= 32)
    (seqparse.c:195-250 FileBuffgetFsaSeq keeps values < 32)."""
    codes = table[np.frombuffer(raw, np.uint8)]
    return codes[codes < 32]


def pack_2bit(codes: np.ndarray):
    """qseq2nibble (qseqs.c:60-88).  Returns (packed u64 words, #N)."""
    n = len(codes)
    ns = int((codes == 4).sum())
    vals = np.where(codes == 4, 0, codes).astype(U64)
    pad = (-n) % 32
    if pad:
        vals = np.concatenate([vals, np.zeros(pad, U64)])
    vals = vals.reshape(-1, 32)
    shifts = (62 - 2 * np.arange(32)).astype(U64)
    words = np.bitwise_or.reduce(vals << shifts, axis=1)
    return words, ns


def unpack_2bit(words: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_2bit (N positions come back as 0/A)."""
    shifts = (62 - 2 * np.arange(32)).astype(U64)
    vals = (words[:, None] >> shifts[None, :]) & U64(3)
    return vals.reshape(-1)[:length].astype(np.uint8)


def n_words(length: int) -> int:
    return (length + 31) // 32


def init_inc_pos(length: int) -> np.ndarray:
    """initIncPos (fsacmp.c:164-179): all-ones bit mask, tail zeroed."""
    inc = np.full(n_words(length), 0xFFFFFFFF, U32)
    if length & 31:
        inc[-1] = U32((0xFFFFFFFF << (32 - (length & 31))) & 0xFFFFFFFF)
    return inc


def bits_to_mask_words(mask_bool: np.ndarray) -> np.ndarray:
    """Per-position bool array -> u32 include words (MSB-first)."""
    n = len(mask_bool)
    pad = (-n) % 32
    if pad:
        mask_bool = np.concatenate([mask_bool,
                                    np.zeros(pad, bool)])
    bits = mask_bool.reshape(-1, 32).astype(U32)
    shifts = (31 - np.arange(32)).astype(U32)
    return np.bitwise_or.reduce(bits << shifts, axis=1)


def mask_words_to_bits(words: np.ndarray, length: int) -> np.ndarray:
    shifts = (31 - np.arange(32)).astype(U32)
    bits = (words[:, None] >> shifts[None, :]) & U32(1)
    return bits.reshape(-1)[:length].astype(bool)


def _span_mask(events: np.ndarray, proxi: int, length: int) -> np.ndarray:
    """Positions masked by the lastSNP proximity chain: for consecutive
    events e_prev < e with e - e_prev <= proxi, mask [e_prev, e].

    The first event never masks: the reference initializes lastSNP = -1
    and its walk condition compares the int -1 against an unsigned end
    (fsacmp.c:217 ``while(lastSNP < end)``), so the loop is skipped —
    verified against compiled behavior."""
    out = np.zeros(length + 1, np.int32)
    if len(events) < 2 or proxi == 0:
        return np.zeros(length, bool)
    prev = events[:-1]
    cur = events[1:]
    close = (cur - prev) <= proxi
    np.add.at(out, prev[close], 1)
    np.add.at(out, cur[close] + 1, -1)
    return np.cumsum(out[:-1]) > 0


def get_inc_pos(inc: np.ndarray, seq: np.ndarray, ref: np.ndarray,
                proxi: int, variant: str = "default") -> None:
    """getIncPos family (fsacmp.c:181-353): AND mismatch/unknown masking
    and proximity pruning into ``inc`` (u32 words, modified in place).

    variant: 'default' (getIncPos — every masked-or-SNP position chains
    proximity), 'insig' (getIncPosInsig — only clean mismatches chain),
    'insigprune' (getIncPosInsigPrune — unknown/insignificant positions
    are masked but don't chain)."""
    length = len(seq)
    c4 = seq == 4
    r4 = ref == 4
    c16 = (seq & 16) != 0
    r16 = (ref & 16) != 0
    neq = seq != ref
    if variant == "default":
        event = neq | c4 | c16
        masked = event & (c4 | r4 | c16 | r16)
        prox_events = event
    elif variant == "insigprune":
        masked = c4 | r4 | ((c16 | r16) & ~(c4 | r4))
        prox_events = ~(c4 | r4) & ~(c16 | r16) & neq
    else:  # insig
        masked = c4 | r4
        prox_events = ~masked & neq
    # clear the insignificance marker exactly where the reference does
    # (fsacmp.c:202-206: only when neither side is unknown; the insig
    # variant never clears, fsacmp.c:296-353)
    if variant == "default":
        clear = event & (c16 | r16) & ~(c4 | r4)
    elif variant == "insigprune":
        clear = (c16 | r16) & ~(c4 | r4)
    else:
        clear = None
    if clear is not None and clear.any():
        seq[clear] &= 15
        ref[clear] &= 15
    if proxi:
        masked = masked | _span_mask(np.flatnonzero(prox_events), proxi,
                                     length)
    if masked.any():
        inc &= ~bits_to_mask_words(masked)


IUPAC_SETS = {0: 0b0001, 1: 0b0010, 2: 0b0100, 3: 0b1000}


def mask_motifs(packed: np.ndarray, inc: np.ndarray, length: int,
                motifs) -> int:
    """maskMotifs (meth.c:139-166): for every motif occurrence, mask the
    capital (methylation-site) positions.  ``motifs`` is a list of
    (codes4, sitemask) pairs from parse_meth_motifs.  Matching runs on the
    packed 2-bit codes (N == A), per-position IUPAC membership."""
    if not motifs:
        return 0
    seq2 = unpack_2bit(packed, length)
    masked = np.zeros(length, bool)
    n = 0
    for codes4, site in motifs:
        mlen = len(codes4)
        if mlen == 0 or mlen > length:
            continue
        ok = np.ones(length - mlen + 1, bool)
        for k in range(mlen):
            member = np.array([(codes4[k] >> b) & 1 for b in range(4)],
                              bool)
            ok &= member[seq2[k:length - mlen + 1 + k]]
        hits = np.flatnonzero(ok)
        n += len(hits)
        for k in np.flatnonzero(site):
            masked[hits + k] = True
    if masked.any():
        inc &= ~bits_to_mask_words(masked)
    return n


# getMethBitTable (methparse.c:47-80): 4-bit IUPAC per base, |16 for
# capital (methylation-site) letters
_METH_TABLE = {}
for _ch, _v in zip("acgturyswkmbdhvxn",
                   (1, 2, 4, 8, 8, 5, 10, 6, 9, 12, 3, 14, 13, 11, 7,
                    15, 15)):
    _METH_TABLE[_ch] = _v
    _METH_TABLE[_ch.upper()] = _v | 16

# strrcMeth (methparse.c:84-101): complement of 5-bit codes (site flag
# preserved)
_METH_COMP = np.array(
    [0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15,
     16, 24, 20, 28, 18, 26, 22, 30, 17, 25, 21, 29, 19, 27, 23, 31],
    np.uint8)

# qseq2methMotif's enumeration tables (methparse.c:185-186): nums =
# membership count per 4-bit set (site flag ignored); bases = FIRST
# member 2-bit code, then `code ^= 1 << member` steps to the next
_METH_NUMS = [0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4] * 2
_METH_BASES = [0, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0]

# The reference's remainder-variant loop reads bases[code | 16] for
# CAPITAL positions — up to sixteen bytes PAST the 16-entry local
# bases[] array (methparse.c:227-234, `base = *seq & 31` keeps the
# site bit).  Both arrays are stack locals; in the oracle's compiled
# qseq2methMotif (gcc -O3, the same methparse.o the test suite links)
# nums[] sits directly after bases[] in the frame, so
# bases[16 + k] == nums[k] — verified by dumping the motif words of a
# probe binary linked against the oracle's libccphylo.a (capital C/G
# remainder variants read 1 == nums[2]/nums[4], not the .rodata image
# neighbors).  The read is OR'd into the motif word as a whole byte;
# nums[15] = 4 leaks one bit into the preceding position's slot.
_METH_GARBAGE = bytes(_METH_NUMS[:16])


def _motif_members(codes5: np.ndarray):
    """qseq2methMotif (methparse.c:179-249), reduced to per-position
    accepted 2-bit code sets.

    Builds the num variant words exactly (member enumeration, capital
    remainder garbage bytes with their bit leaks, fence-post shift),
    then extracts each position's final 2-bit code per variant.  The
    matcher's per-slot mismatch marks AND'd across variants
    (matchMotif32, meth.c:50-66) make a window match iff every
    position's sequence code equals SOME variant's code there, so the
    4-bit membership masks below are exact."""
    mlen = len(codes5)
    num = max(_METH_NUMS[c] for c in codes5)
    nchunks = (mlen + 31) // 32
    words = [[0] * num for _ in range(nchunks)]
    site = np.zeros(mlen, bool)
    for i, c in enumerate(codes5):
        c = int(c)
        ch = i // 32
        base = c
        if c & 16:
            base = c ^ 16
            site[i] = True
        b = base
        k = _METH_NUMS[base]
        for v in range(k):
            m = _METH_BASES[b]
            words[ch][v] = (words[ch][v] << 2) | m
            b ^= 1 << m
        g = (_METH_GARBAGE[(c & 31) - 16] if (c & 31) >= 16
             else _METH_BASES[c & 31])
        for v in range(k, num):
            words[ch][v] = (words[ch][v] << 2) | g
    if mlen & 31:
        sh = 2 * (32 - (mlen & 31))
        last = nchunks - 1
        for v in range(num):
            words[last][v] <<= sh
    member4 = np.zeros(mlen, np.uint8)
    for i in range(mlen):
        ch, q = i // 32, i % 32
        for v in range(num):
            code = (words[ch][v] >> (62 - 2 * q)) & 3
            member4[i] |= np.uint8(1 << code)
    return member4, site


def _strrc_meth(codes5: np.ndarray) -> np.ndarray:
    """strrcMeth (methparse.c:84-101) exactly, including its odd-length
    in-place quirk: after the half-swap loop the pointer sits at index
    h-1 (not the middle h), so the "middle" fixup double-complements
    s[h-1] (restoring the uncomplemented s[h+1]) and the true middle
    keeps its original (uncomplemented) code."""
    s = codes5.copy()
    q_len = len(s)
    h = q_len >> 1
    for k in range(h):
        a, b = s[k], s[q_len - 1 - k]
        s[k] = _METH_COMP[b]
        s[q_len - 1 - k] = _METH_COMP[a]
    if q_len & 1 and h >= 1:
        s[h - 1] = _METH_COMP[s[h - 1]]
    # q_len == 1: the fixup writes one byte BEFORE the buffer
    # (methparse.c:92 --qseq with zero loop iterations) — a no-op on
    # the motif itself
    return s


def parse_meth_motifs(data: bytes):
    """getMethMotifs (methparse.c:253-286): fasta of motifs; capital
    letters mark methylation sites; returns [(member4, site_bool)]
    with reverse complements appended after each motif (prepend order
    of the C linked list is irrelevant to the resulting mask).
    member4[i] = 4-bit set of accepted 2-bit codes at position i,
    derived from the reference's exact variant words (see
    _motif_members)."""
    motifs = []
    for chunk in data.split(b">"):
        lines = chunk.split(b"\n")
        seqraw = b"".join(lines[1:]) if len(lines) > 1 else lines[0]
        codes = [_METH_TABLE[chr(b)] for b in seqraw
                 if chr(b) in _METH_TABLE]
        if not codes:
            continue
        codes5 = np.array(codes, np.uint8)
        motifs.append(_motif_members(codes5))
        motifs.append(_motif_members(_strrc_meth(codes5)))
    return motifs
