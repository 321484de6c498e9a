"""`tree` subcommand: Phylip matrices -> Newick trees (reference tree.c;
counterpart of ccphylo_tpu/cli/tree_cmd.py).

Matches the reference CLI surface (tree.c:122-470) and its output byte
for byte: one Newick line per input matrix, '>'-prefixed header when the
matrix carried a '#'-comment, timings on stderr.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

from ..io import fileio
from ..io.phylip import PhylipStream
from ..io.qseqs import Name
from ..tree.exact import METHODS, build_tree
from ..tree.newick_build import form_last_bi_node
from ..utils import timing
from .args import Args, ArgError

HELP = """\
#CCPhylo forms tree(s) in newick format given a set of phylip distance matrices.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file                      \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -S, --separator       \tSeparator                       \t\\t
#    -q, --quotes          \tQuote taxa                      \t\\0
#    -x, --print_precision \tFloating point print precision  \t9
#    -m, --method          \tTree construction method.       \tdnj
#    -M, --method_help     \tHelp on option "-m"             \t
#    -f, --flag            \tOutput flags                    \t0
#    -F, --flag_help       \tHelp on option "-f"             \t
#    -p, --float_precision \tFloat precision on distance matrix\tFalse / double
#    -s, --short_precision \tShort precision on distance matrix\tFalse / double / 1e0
#    -b, --byte_precision  \tByte precision on distance matrix\tFalse / double / 1e0
#    -g, --free            \tGradually free up D             \tFalse
#    -H, --mmap            \tAllocate matrix on the disk     \tFalse
#    -T, --tmp             \tSet directory for temporary files\t
#    -t, --threads         \tNumber of threads               \t1
#    -h, --help            \tShows this helpmessage          \t
"""

METHOD_HELP = """\
# Tree construction methods:
#
# nj      \tNeighbor-Joining
# upgma   \tUPGMA
# cf      \tK-means Closest First
# ff      \tK-means Furthest First
# mn      \tMinimum Neighbors
# hnj     \tHeuristic Neighbor-Joining
# dnj     \tDynamic Neighbor-Joining
#
"""

FLAG_HELP = """\
# Format flags output, add them to combine them.
#
#   1:\tStrictly bifurcate the root
#   2:\tAllow negative branchlengths
#
"""


def main_tree(argv: list[str]) -> int:
    inputfile = "-"
    outputfile = "-"
    sep = "\t"
    quotes = "\0"
    precision = 9
    method = "dnj"
    flag = 0
    dtype = "d"
    bytescale = 1.0  # ByteScale default (bytescale.c:22)
    threads = 1  # -t parallelizes the host dnj batch scan; output is
    #              thread-count independent (as is the reference's)

    use_mmap = False
    tmpdir = None
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
                inputfile = a.next_value("input")
            elif name == "output":
                outputfile = a.next_value("output")
            elif name == "separator":
                sep = a.next_char("separator")
            elif name == "quotes":
                quotes = a.next_char("quotes")
            elif name == "print_precision":
                precision = a.next_num("print_precision")
            elif name == "method":
                method = a.next_value("method")
            elif name == "method_help":
                method = "mh"
            elif name == "flag":
                flag = a.next_num("flag")
            elif name == "flag_help":
                flag = -1
            elif name == "threads":
                threads = a.next_num("threads")
            elif name == "float_precision":
                dtype = "f"
            elif name == "short_precision":
                dtype = "s"
                bytescale = a.opt_float(bytescale)
            elif name == "byte_precision":
                dtype = "b"
                bytescale = a.opt_float(bytescale)
            elif name == "free":
                pass  # shrink-as-you-go: no effect on output
            elif name == "mmap":
                use_mmap = True
            elif name == "tmp":
                tmpdir = a.next_value("tmp")
            elif name == "help":
                sys.stdout.write(HELP)
                return 0
            else:
                raise ArgError(f'Unknown argument or option: "{arg}"')
        elif arg.startswith("-") and arg != "-":
            for opt in arg[1:]:
                if opt == "i":
                    inputfile = a.next_value("i")
                elif opt == "o":
                    outputfile = a.next_value("o")
                elif opt == "S":
                    sep = a.next_char("S")
                elif opt == "q":
                    quotes = a.next_char("q")
                elif opt == "x":
                    precision = a.next_num("x")
                elif opt == "m":
                    method = a.next_value("m")
                elif opt == "M":
                    method = "mh"
                elif opt == "f":
                    flag = a.next_num("f")
                elif opt == "F":
                    flag = -1
                elif opt == "t":
                    threads = a.next_num("t")
                elif opt == "p":
                    dtype = "f"
                elif opt == "s":
                    dtype = "s"
                    bytescale = a.opt_float(bytescale)
                elif opt == "b":
                    dtype = "b"
                    bytescale = a.opt_float(bytescale)
                elif opt == "g":
                    pass
                elif opt == "H":
                    use_mmap = True
                elif opt == "T":
                    tmpdir = a.next_value("T")
                elif opt == "h":
                    sys.stdout.write(HELP)
                    return 0
                else:
                    raise ArgError(f'Unknown argument or option: "{opt}"')
        else:
            inputfile = arg
        a.i += 1

    if flag == -1:
        sys.stdout.write(FLAG_HELP)
        return 0
    if method == "mh":
        sys.stdout.write(METHOD_HELP)
        return 0
    if method not in METHODS:
        raise ArgError('Invalid value parsed at "-m".')
    _engine()  # an unknown engine is an argument error, before any load

    if use_mmap:
        # -H: disk-backed matrix cells (ltdMatrixMinit, matrix.c:116);
        # -T sets the backing directory (tmpF, tmp.c:27)
        from ..tree.exact import LtdMatrix
        LtdMatrix.mmap_dir = tmpdir or tempfile.gettempdir()

    return form_tree(inputfile, outputfile, flag, sep, quotes, method,
                     precision, dtype, bytescale, threads)


# values of CCPHYLO_TORCH_ENGINE that name an engine of the reference
# with no counterpart yet, and the ROADMAP.md item that ports each
_UNPORTED_ENGINES = {
    "device": "A6 (tree/jax_engine.py) and A7 (tree/hclust_engine.py)",
    "device64": "A6 (tree/jax_engine.py) and A7 (tree/hclust_engine.py)",
    "sharded": "A10 (parallel/ on torch.distributed)",
}


def _engine() -> str:
    """CCPHYLO_TORCH_ENGINE: ``packed`` (default) or ``exact``."""
    eng = os.environ.get("CCPHYLO_TORCH_ENGINE", "packed")
    if eng in ("packed", "exact"):
        return eng
    if eng in _UNPORTED_ENGINES:
        raise ArgError(f"CCPHYLO_TORCH_ENGINE={eng} is not ported yet: "
                       f"ROADMAP.md item {_UNPORTED_ENGINES[eng]}; the "
                       "engines are packed and exact.")
    raise ArgError(f'Invalid value of CCPHYLO_TORCH_ENGINE: "{eng}" '
                   "(packed or exact).")


def _dispatch_build(flat, n, names, method, flag, precision, dtype,
                    bytescale, threads=1):
    """Choose the join engine.

    ``-m dnj -b`` on a complete matrix runs the packed exact-int32 u8
    engine (tree/packed_engine.py) on the torch device of
    utils/torchconfig.py, unless CCPHYLO_TORCH_ENGINE=exact.  Everything
    else runs the host exact engine (byte parity with the reference for
    every method and dtype): other methods and dtypes, and matrices with
    missing (negative) cells, which quantized storage cannot hold.
    """
    if _engine() == "packed" and method == "dnj" and dtype == "b" \
            and not (np.asarray(flat) < 0).any():
        from ..tree.packed_engine import build_tree_packed
        return build_tree_packed(flat, n, names, flag, precision,
                                 bytescale=bytescale)
    return build_tree(flat, n, names, method, flag, precision, dtype,
                      bytescale, threads)


def form_tree(inputfile, outputfile, flag, sep, quotes, method, precision,
              dtype, bytescale, threads=1) -> int:
    """formTree (tree.c:37-120)."""
    data = fileio.read_bytes(inputfile)
    stream = PhylipStream(data, sep=sep.encode(), quotes=quotes.encode())
    out = fileio.open_out(outputfile)
    t0 = time.process_time()
    while True:
        loaded = stream.load()
        if loaded is None or loaded[0] == 0:
            break
        n, flat, names, header = loaded
        t1 = time.process_time()
        print(f"# Total time used loading matrix: {t1 - t0:.2f} s.",
              file=sys.stderr)
        t0 = t1
        if n > 2:
            # pass the live name list: the engine's swap-with-last
            # reordering persists across matrices in a stream, exactly as
            # the reference's shared Qseqs* array does (tree.c:82-98)
            with timing.phase("tree/joins", items=max(n - 2, 0)):
                tree = _dispatch_build(flat, n, names, method, flag,
                                       precision, dtype, bytescale,
                                       threads)
        elif n == 2:
            root = names[0]
            form_last_bi_node(root, names[1], float(flat[0]), precision)
            tree = root.data
        else:
            tree = names[0].data
        if header:
            out.write(b">" + header + tree + b";\n")
        else:
            out.write(tree + b";\n")
        t1 = time.process_time()
        print(f"# Total time used Constructing tree: {t1 - t0:.2f} s.",
              file=sys.stderr)
        t0 = t1
    fileio.close_out(out)
    return 0
