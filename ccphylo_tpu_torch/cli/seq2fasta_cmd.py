"""`seq2fasta` subcommand: dump fasta sequences from a KMA index
(reference seq2fasta.c).  Not dispatched from the reference's main
(used internally by `union -r`); exposed here with the same CLI.

Counterpart of ccphylo_tpu/cli/seq2fasta_cmd.py: the port's own copy."""

from __future__ import annotations

import sys

from ..io import kmadb


def main_seq2fasta(argv: list[str]) -> int:
    dbname = None
    seqlist = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-t_db":
            i += 1
            if i < len(argv):
                dbname = argv[i]
        elif a == "-seqs":
            i += 1
            if i < len(argv):
                try:
                    seqlist = [int(x) for x in argv[i].split(",")]
                except ValueError:
                    print("Invalid list parsed.", file=sys.stderr)
                    return 1
        elif a == "-h":
            _help(sys.stdout)
            return 0
        else:
            _help(sys.stderr)
            return 1
        i += 1
    if not dbname:
        print("Need a db", file=sys.stderr)
        _help(sys.stderr)
        return 1
    out = sys.stdout.buffer
    for name, seq in kmadb.iter_fastas(dbname, seqlist):
        out.write(b">" + name + b"\n" + seq + b"\n")
    out.flush()
    return 0


def _help(out) -> None:
    out.write("kma seq2fasta prints the fasta sequence of a given kma "
              "index to stdout.\n"
              "# Options are:\tDesc:\t\t\t\t\tDefault:\tRequirements:\n"
              "#\t-t_db\tTemplate DB\t\t\t\tNone\t\tREQUIRED\n"
              "#\t-seqs\tComma separated list of templates\tPrint entire "
              "index.\n"
              "#\t-h\tShows this help message\n")
