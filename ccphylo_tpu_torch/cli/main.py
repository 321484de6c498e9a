"""Top-level dispatch (reference main.c:99-131; counterpart of
ccphylo_tpu/cli/main.py).

Usage: ``python -m ccphylo_tpu_torch <subcommand> [options]``.  `dist`
and `tree` are ported; the other twelve subcommands of the reference
are named in the help text and refused with one line on stderr until
their modules are ported (ROADMAP.md, queue A).
"""

from __future__ import annotations

import sys

from .. import __version__

# subcommands of the reference whose modules are not ported yet
UNPORTED = ("dbscan", "union", "merge", "nwck2phy", "tsv2phy", "tsv2nwck",
            "rarify", "trim", "phycmp", "fullphy", "makespan", "seq2fasta")


def _help(out) -> int:
    out.write(f"""\
# CCPhylo-TPU {__version__}: TPU-native phylogenetic analyses on KMA alignments.
#
# Subcommands:\tDesc:
# dist\t\tMake distance matrices based on multiple alignments
# tree\t\tMake trees based on distance matrices
# dbscan\tMake DBSCAN based on distance matrices
# union\t\tFind union of templates between smaples
# merge\t\tMerge distance matrices
# nwck2phy\tConvert Newick files to phylip distance files
# tsv2phy\tConvert tsv files to phylip distance files
# tsv2nwck\tConvert tsv files to newick files
# rarify\tRarify kma matrices
# trim\t\tTrim multiple alignments
# phycmp\tCompare phylip distance matrices
# fullphy\tConvert phylip distance matrices to full matrices
# makespan\tCluster jobs into partitions
# seq2fasta\tExtract fastas from KMA databases
""")
    return 0 if out is sys.stdout else 1


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        return _help(sys.stderr)
    cmd, rest = argv[0], argv[1:]

    if cmd in ("-h", "--help", "help"):
        return _help(sys.stdout)
    if cmd in ("-v", "--version"):
        print(__version__)
        return 0

    if cmd == "tree":
        from .tree_cmd import main_tree
        return main_tree(rest)
    if cmd == "dist":
        from .dist_cmd import main_dist
        return main_dist(rest)
    if cmd in UNPORTED:
        print(f"ccphylo_tpu_torch: subcommand \"{cmd}\" is not ported "
              "yet (ported: dist, tree).", file=sys.stderr)
        return 1

    print(f'Unknown subcommand:\t"{cmd}"', file=sys.stderr)
    return _help(sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
