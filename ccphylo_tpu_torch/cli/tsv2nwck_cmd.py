"""`tsv2nwck` subcommand: tsv rows -> Newick via nearest-neighbour
clustering (reference tsv2nwck.c + datclust.c).

Note: the reference compiles this subcommand but never dispatches it
from main.c (an orphan); we expose it.

Counterpart of ccphylo_tpu/cli/tsv2nwck_cmd.py: the port's own copy.
"""

from __future__ import annotations

import sys

from ..io import fileio
from ..io.qseqs import Name
from ..io.tsv import load_tsv
from ..ops.distcmp import get_distcmp
from ..tree.newick_build import form_node, form_last_node
from .args import Args, ArgError

DBL_MAX = 1.7976931348623157e+308

HELP = """\
#CCPhylo tsv2nwck converts tsv files to newick files.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file                      \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -S, --separator       \tSeparator                       \t\\t
#    -x, --print_precision \tFloating point print precision  \t9
#    -d, --distance        \tDistance method                 \tcos
#    -D, --distance_help   \tHelp on option "-d"             \t
#    -p, --float_precision \tFloat precision on distance matrix\tFalse / double
#    -s, --short_precision \tShort precision on distance matrix\tFalse / double / 1e0
#    -b, --byte_precision  \tByte precision on distance matrix\tFalse / double / 1e0
#    -h, --help            \tShows this helpmessage          \t
"""


def main_tsv2nwck(argv: list[str]) -> int:
    inputfile = "-"
    outputfile = "-"
    sep = "\t"
    precision = 9
    method = "cos"
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
            elif name == "print_precision":
                precision = a.next_num("print_precision")
            elif name == "distance":
                method = a.next_value("distance")
            elif name == "distance_help":
                method = None
            elif name == "float_precision":
                dtype = "f"
            elif name == "short_precision":
                dtype = "s"
                bytescale = a.opt_float(bytescale)
            elif name == "byte_precision":
                dtype = "b"
                bytescale = a.opt_float(bytescale)
            elif name in ("mmap",):
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
                elif opt == "x":
                    precision = a.next_num("x")
                elif opt == "d":
                    method = a.next_value("d")
                elif opt == "D":
                    method = None
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

    if method is None:
        sys.stdout.write("# Distance calculation methods: see tsv2phy "
                         "-D\n")
        return 0
    fn = get_distcmp(method)
    if fn is None:
        raise ArgError('Invalid value parsed at "--distance".')

    dat = load_tsv(fileio.read_bytes(inputfile), sep.encode(), dtype,
                   bytescale)
    if dat is None:
        print("Input matrix contained zero rows.", file=sys.stderr)
        return 0
    m = dat.m
    # initQ_Dmat (datclust.c:30-96): Q[i] seeds unconditionally from
    # row 0, then <= last-wins over valid j < i
    Q = [DBL_MAX] * m
    P = [-1] + [0] * (m - 1)
    for i in range(1, m):
        Q[i] = fn(dat.mat[i], dat.mat[0], dtype, bytescale)
        for j in range(1, i):
            d = fn(dat.mat[i], dat.mat[j], dtype, bytescale)
            if 0 <= d <= Q[i]:
                Q[i] = d
                P[i] = j

    names = [Name(b"%d" % i, 10) for i in range(m)]

    # tclust (datclust.c:136-178)
    j = 0
    n = m
    while n != 1:
        # minQ over rows 1..m-1, <= last-wins (hclust.c:353-381)
        mi = 0
        mn = DBL_MAX
        for k in range(1, m):
            if Q[k] <= mn:
                mn = Q[k]
                mi = k
        if mi == 0 and (P[mi] if mi else 0) == 0:
            break
        i = mi
        j = P[i]
        if j < 0:
            break  # remaining rows exhausted (joined rows)
        limb = Q[i] / 2
        form_node(names[j], names[i], limb, limb, precision)
        # updateQP (datclust.c:99-111)
        Q[i] = DBL_MAX
        P[i] = -1
        for k in range(i + 1, m):
            if P[k] == i:
                P[k] = j
        n -= 1
    if n != 1:
        # pairU leftovers (datclust.c:113-133, 156-168)
        while n != 1:
            first = -1
            second = -1
            for k in range(1, m):
                if P[k] != -1:
                    if first < 0:
                        first = k
                    else:
                        second = k
                        break
            if second < 0:
                break
            i, j = first, second
            form_last_node(names[j], names[i], -1.0, precision)
            P[i] = -1
            n -= 1
    names[0], names[j] = names[j], names[0]

    out = fileio.open_out(outputfile)
    out.write(names[0].data + b";\n")
    fileio.close_out(out)
    return 0
