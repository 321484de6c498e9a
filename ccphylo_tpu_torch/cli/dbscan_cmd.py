"""`dbscan` subcommand: DBSCAN over Phylip matrices (reference
dbscan.c).

Counterpart of ccphylo_tpu/cli/dbscan_cmd.py: the port's own copy."""

from __future__ import annotations

import sys

from ..io import fileio
from ..io.phylip import PhylipStream
from ..tree.exact import LtdMatrix, off
from .args import Args, ArgError

HELP = """\
#CCPhylo make a DBSCAN given a set of phylip distance matrices.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file                      \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -S, --separator       \tSeparator                       \t\\t
#    -q, --quotes          \tQuote taxa                      \t\\0
#    -N, --min_neighbors   \tMinimum neighbors               \t1
#    -e, --max_distance    \tMaximum distance                \t10.0
#    -p, --float_precision \tFloat precision on distance matrix\tdouble
#    -s, --short_precision \tShort precision on distance matrix\tdouble / 1e0
#    -b, --byte_precision  \tByte precision on distance matrix\tdouble / 1e0
#    -H, --mmap            \tAllocate matrix on the disk     \tFalse
#    -T, --tmp             \tSet directory for temporary files\t
#    -h, --help            \tShows this helpmessage          \t
"""


def dbscan(lt: LtdMatrix, n: int, max_dist: float, min_n: int):
    """dbscan (dbscan.c:31-163): neighbor counts + union-to-earliest
    cluster assignment, replicated including the mid-loop shrinking
    bound and the neighbor-budget early exit."""
    N = [0] * n
    C = [0] * n
    flat = lt.get(slice(0, off(n) + max(n - 1, 0)))
    for i in range(n):
        o = off(i)
        cnt = 0
        for j in range(i):
            if flat[o + j] <= max_dist:
                cnt += 1
                N[j] += 1
        N[i] = cnt
        C[i] = i

    nclust = 0
    for i in range(n):
        o = off(i)
        if min_n <= N[i]:
            c = i
            j = -1
            while (j := j + 1) < c:
                if flat[o + j] <= max_dist:
                    c = C[j]
            if i != c:
                C[i] = c
            else:
                nclust += 1
        elif N[i]:
            n_i = N[i]
            c = i
            j = -1
            while (j := j + 1) < c:
                if flat[o + j] <= max_dist:
                    if min_n <= N[j]:
                        c = C[j]
                    else:
                        n_i -= 1
                        if not n_i:
                            j = c  # no more neighbors (dbscan.c:143-146)
            if i != c:
                C[i] = c
            else:
                nclust += 1
        else:
            nclust += 1
    return N, C, nclust


def main_dbscan(argv: list[str]) -> int:
    inputfile = "-"
    outputfile = "-"
    sep = "\t"
    quotes = "\0"
    max_dist = 10.0
    min_n = 1
    dtype = "d"
    bytescale = 1.0

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
            elif name == "min_neighbors":
                min_n = a.next_num("min_neighbors")
            elif name == "max_distance":
                max_dist = a.next_float("max_distance")
            elif name == "float_precision":
                dtype = "f"
            elif name == "short_precision":
                dtype = "s"
                bytescale = a.opt_float(bytescale)
            elif name == "byte_precision":
                dtype = "b"
                bytescale = a.opt_float(bytescale)
            elif name == "mmap":
                pass
            elif name == "tmp":
                a.next_value("tmp")
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
                elif opt == "N":
                    min_n = a.next_num("N")
                elif opt == "e":
                    max_dist = a.next_float("e")
                elif opt == "p":
                    dtype = "f"
                elif opt == "s":
                    dtype = "s"
                    bytescale = a.opt_float(bytescale)
                elif opt == "b":
                    dtype = "b"
                    bytescale = a.opt_float(bytescale)
                elif opt == "H":
                    pass
                elif opt == "T":
                    a.next_value("T")
                elif opt == "h":
                    sys.stdout.write(HELP)
                    return 0
                else:
                    raise ArgError(f'Unknown argument or option: "{opt}"')
        else:
            inputfile = arg
        a.i += 1

    data = fileio.read_bytes(inputfile)
    stream = PhylipStream(data, sep=sep.encode(), quotes=quotes.encode())
    out = fileio.open_out(outputfile)
    while True:
        loaded = stream.load()
        if loaded is None or loaded[0] == 0:
            break
        n, flat, names, header = loaded
        lt = LtdMatrix(flat, n, dtype, bytescale)
        N, C, nclust = dbscan(lt, n, max_dist, min_n)
        if header:
            out.write(b"#" + header + b"\n")
        out.write(b"## %d\t%d\t%f\t%d\n" % (n, nclust, max_dist, min_n))
        out.write(b"#Sample\tNeighbors\tCluster\n")
        for i in range(n):
            out.write(names[i].data + b"\t%d\t%d\n" % (N[i], C[i]))
    fileio.close_out(out)
    return 0
