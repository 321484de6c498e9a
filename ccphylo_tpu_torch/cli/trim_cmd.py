"""`trim` subcommand: trim multiple alignments (reference trim.c).

Shared mode accumulates one include mask against the first included
reference and reprints every saved sequence through it (in reverse
storage order, trim.c:252-258); pairwise mode streams each record
through its own mask.  flag&16 prunes to variant-only columns
(pseudoAlnPrune, fsacmp.c:505-550).

Counterpart of ccphylo_tpu/cli/trim_cmd.py: the port's own copy.
"""

from __future__ import annotations

import sys

import numpy as np

from ..io import fileio, kma
from ..io.phylip import strip_dir
from ..ops import pack2bit, snp
from .args import Args, ArgError

HELP = """\
#CCPhylo trims multiple alignments from different files, and merge them into one
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file(s)                   \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -y, --methylation_motifs\tMask methylation motifs from <file>\tFalse/None
#    -r, --reference       \tTarget reference identifier     \tNone
#    -C, --min_cov         \tMinimum coverage                \t50.0%
#    -L, --min_len         \tMinimum overlapping length      \t1
#    -P, --proximity       \tMinimum proximity between SNPs  \t0
#    -f, --flag            \tOutput flags                    \t0
#    -F, --flag_help       \tHelp on option "-f"             \t
#    -h, --help            \tShows this helpmessage          \t
"""

FLAG_HELP = """\
# Format flags output, add them to combine them.
#
#   1:\tHard mask
#   2:\tPairwise comparison
#   4:\tMask gaps and ambiguous bases
#   8:\tUnmask soft masked bases in input
#  16:\tCreate pseudo alignment, not compatible with pairwise comparison
#  32:\tDo not include insignificant bases in pruning
#
"""

BASES = b"ACGTN-RYSWKMBDHV"


def print_trim_fsa(out, name: bytes, codes: np.ndarray, incbits,
                   flag: int):
    """printTrimFsa (trim.c:37-75)."""
    out.write(b">" + strip_dir(name) + b"\n")
    lut = np.frombuffer(BASES, np.uint8)
    vals = lut[(codes & 15).astype(np.intp)]
    # uncleared insignificance markers index past bases[16] — the
    # binary's adjacent rodata is zero, so they print as NUL
    # (trim.c:39,50; observed against the oracle)
    vals = np.where((codes & 16) != 0, 0, vals).astype(np.uint8)
    if (flag & 18) == 16:
        out.write(vals[incbits].tobytes() + b"\n")
    else:
        if flag & 1:
            excl = np.full(len(vals), ord("N"), np.uint8)
        else:
            # tolower: letters gain 32; '-' and NUL stay
            excl = np.where((vals == ord("-")) | (vals == 0), vals,
                            vals + 32).astype(np.uint8)
        out.write(np.where(incbits, vals, excl).tobytes() + b"\n")


def pseudo_aln_prune(incbits: np.ndarray, stored: list) -> None:
    """pseudoAlnPrune (fsacmp.c:505-550): keep only columns where any
    sequence differs from the first non-null one."""
    seqs = [s for s in stored]
    ref = None
    k = 0
    while k < len(seqs) and seqs[k] is None:
        k += 1
    if k >= len(seqs):
        return
    ref = seqs[k]
    consensus = np.zeros(len(ref), bool)
    for s in seqs[k + 1:]:
        if s is not None:
            consensus |= s != ref
    incbits &= consensus


def main_trim(argv: list[str]) -> int:
    filenames: list[str] = []
    outputfile = "-"
    methfilename = None
    target = None
    min_cov = 0.5
    min_length = 1
    proxi = 0
    flag = 0

    a = Args(argv)
    while a.i < len(a.argv):
        arg = a.argv[a.i]
        if arg.startswith("--"):
            name, eq, val = arg[2:].partition("=")
            if eq:
                a.argv.insert(a.i + 1, val)
            if name == "":
                break
            elif name == "input":
                while (a.i + 1 < len(a.argv)
                       and not a.argv[a.i + 1].startswith("-")):
                    filenames.append(a.next_value("input"))
            elif name == "output":
                outputfile = a.next_value("output")
            elif name == "methylation_motifs":
                methfilename = a.next_value("methylation_motifs")
            elif name == "reference":
                target = a.next_value("reference")
            elif name == "min_cov":
                min_cov = a.next_float("min_cov") / 100
            elif name == "min_len":
                min_length = a.next_num("min_len")
            elif name == "proximity":
                proxi = a.next_num("proximity")
            elif name == "flag":
                flag = a.next_num("flag")
            elif name == "flag_help":
                flag = -1
            elif name == "help":
                sys.stdout.write(HELP)
                return 0
            else:
                raise ArgError(f'Unknown argument or option: "{arg}"')
        elif arg.startswith("-") and arg != "-":
            for opt in arg[1:]:
                if opt == "i":
                    while (a.i + 1 < len(a.argv)
                           and not a.argv[a.i + 1].startswith("-")):
                        filenames.append(a.next_value("i"))
                elif opt == "o":
                    outputfile = a.next_value("o")
                elif opt == "y":
                    methfilename = a.next_value("y")
                elif opt == "r":
                    target = a.next_value("r")
                elif opt == "C":
                    min_cov = a.next_float("C") / 100
                elif opt == "L":
                    min_length = a.next_num("L")
                elif opt == "P":
                    proxi = a.next_num("P")
                elif opt == "f":
                    flag = a.next_num("f")
                elif opt == "F":
                    flag = -1
                elif opt == "h":
                    sys.stdout.write(HELP)
                    return 0
                else:
                    raise ArgError(f'Unknown argument or option: "{opt}"')
        else:
            filenames.append(arg)
        a.i += 1

    if flag == -1:
        sys.stdout.write(FLAG_HELP)
        return 0
    incvariant = ("insigprune" if flag & 32 else
                  "insig" if flag & 8 else "default")
    if flag & 4:
        trans = pack2bit.get_2bit_table(flag)
    else:
        trans = pack2bit.get_iupac_bit_table(flag)
    motifs = []
    if methfilename:
        motifs = pack2bit.parse_meth_motifs(
            fileio.read_bytes(methfilename))
    if not filenames:
        filenames = ["-"]

    pair = bool(flag & 2)
    out = fileio.open_out(outputfile)
    length = 0
    ref = None
    includes = None
    stored: list[np.ndarray | None] = []
    stored_names: list[bytes] = []
    include_n = 0
    n_seqs = 0
    tgt = target.encode() if target else None

    for fn in filenames:
        data = fileio.read_bytes(fn)
        if data[:1] != b">":
            print(f'"{fn}" is not fasta.', file=sys.stderr)
            sys.exit(1)
        found = False
        for header, raw in kma.iter_fasta(data):
            if tgt is not None and header != tgt:
                continue
            found = True
            seq = pack2bit.translate(raw, trans)
            label = fn.encode() if tgt is not None else header
            if ref is None:
                length = len(seq)
                if min_length < int(min_cov * length):
                    min_length = int(min_cov * length)
                inc = pack2bit.init_inc_pos(length)
                packed, _ = pack2bit.pack_2bit(seq)
                pack2bit.mask_motifs(packed, inc, length, motifs)
                # the first candidate always uses plain getIncPos
                # (trim.c:197)
                pack2bit.get_inc_pos(inc, seq, seq, proxi, "default")
                npos = snp.get_npos(inc)
                if npos < min_length:
                    print(f"# Excluded:\t{label.decode()}\t( {npos} / "
                          f"{length} )", file=sys.stderr)
                    include_n += 1
                    if tgt is not None and not pair:
                        stored.append(None)
                else:
                    print(f"# Included:\t{label.decode()}\t( {npos} / "
                          f"{length} )", file=sys.stderr)
                    include_n += 1
                    if pair:
                        includes = inc
                        print_trim_fsa(out, label, seq,
                                       pack2bit.mask_words_to_bits(
                                           inc, length), flag)
                        ref = seq
                    else:
                        includes = inc
                        ref = seq.copy()
                        stored.append(seq.copy())
                        stored_names.append(header)
                        n_seqs += 1
            else:
                if len(seq) != length:
                    print(f"Sequences does not match: {header.decode()} "
                          f"{fn}", file=sys.stderr)
                    sys.exit(1)
                if pair:
                    inc = pack2bit.init_inc_pos(length)
                    packed, _ = pack2bit.pack_2bit(seq)
                    pack2bit.mask_motifs(packed, inc, length, motifs)
                    pack2bit.get_inc_pos(inc, seq, seq, proxi,
                                         incvariant)
                    npos = snp.get_npos(inc)
                    tag = ("Included" if npos >= min_length
                           else "Excluded")
                    print(f"# {tag}:\t{label.decode()}\t( {npos} / "
                          f"{length} )", file=sys.stderr)
                    if npos >= min_length:
                        include_n += 1
                    print_trim_fsa(out, label, seq,
                                   pack2bit.mask_words_to_bits(
                                       inc, length), flag)
                else:
                    packed, ns = pack2bit.pack_2bit(seq)
                    npos = length - ns
                    if npos < min_length:
                        print(f"# Excluded:\t{label.decode()}\t( {npos} "
                              f"/ {length} )", file=sys.stderr)
                        stored.append(None)
                        if n_seqs:
                            stored_names[-1] = header
                    else:
                        print(f"# Included:\t{label.decode()}\t( {npos} "
                              f"/ {length} )", file=sys.stderr)
                        pack2bit.mask_motifs(packed, includes, length,
                                             motifs)
                        pack2bit.get_inc_pos(includes, seq, ref, proxi,
                                             incvariant)
                        stored.append(seq.copy())
                        stored_names.append(header)
                        n_seqs += 1
                        include_n += 1
            if tgt is not None:
                break
        if tgt is not None and not found:
            print(f'Missing template entry ("{target}") in file:\t{fn}',
                  file=sys.stderr)
            if not pair:
                stored.append(None)

    if not include_n:
        print("All sequences were trimmed away.", file=sys.stderr)
        fileio.close_out(out)
        return 1
    if not pair:
        npos = snp.get_npos(includes)
        print(f"# {npos} / {length} bases included in distance matrix.",
              file=sys.stderr)
        incbits = pack2bit.mask_words_to_bits(includes, length)
        if flag & 16:
            pseudo_aln_prune(incbits, stored)
            print(f"# {int(incbits.sum())} / {npos} positions with "
                  "variance", file=sys.stderr)
        # reverse storage-order final print (trim.c:252-258)
        if tgt is not None:
            labels = [f.encode() for f in filenames]
            slots = list(zip(stored, labels))
        else:
            slots = list(zip(stored,
                             [nm for nm in stored_names]))
            # only the last n_seqs slots are revisited
            slots = slots[-n_seqs:] if n_seqs else []
        for seq, label in reversed(slots):
            if seq is not None:
                print_trim_fsa(out, label, seq, incbits, flag)
    fileio.close_out(out)
    return 0
