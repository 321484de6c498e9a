"""`merge` subcommand: merge multi-Phylip matrices (reference
merge.c).

Counterpart of ccphylo_tpu/cli/merge_cmd.py: the port's own copy."""

from __future__ import annotations

import sys

import numpy as np

from ..io import fileio
from ..io.phylip import PhylipStream, print_phy
from ..io.hashmapstr import HashMapStr
from ..tree.exact import LtdMatrix, off
from .args import Args, ArgError

HELP = """\
#CCPhylo merges matrices from a multi Phylip file into one matrix
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput multi phylip distance file\tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -w, --nucleotides_weights\tWeigh distance with this Phylip file\t
#    -n, --nucleotide_numbers\tOutput number of nucleotides included\tFalse/None
#    -S, --separator       \tSeparator                       \t\\t
#    -x, --print_precision \tFloating point print precision  \t9
#    -f, --flag            \tOutput flags                    \t1
#    -F, --flag_help       \tHelp on option "-f"             \t
#    -p, --float_precision \tFloat precision on distance matrix\tdouble
#    -s, --short_precision \tShort precision on distance matrix\tdouble / 1e0
#    -b, --byte_precision  \tByte precision on distance matrix\tdouble / 1e0
#    -H, --mmap            \tAllocate matrix on the disk     \tFalse
#    -T, --tmp             \tSet directory for temporary files\t
#    -h, --help            \tShows this helpmessage          \t
"""


class NameIndex:
    """HashMapStrindex (hashmapstrindex.c:24-50): name -> first-seen
    running index."""

    def __init__(self):
        self.map = HashMapStr(128)
        self.count = 0

    def add(self, name: bytes) -> int:
        """Returns the name's merged-matrix index (first-seen order)."""
        h_ulist = self.map.pop(name)
        if h_ulist is not None:
            # re-link (pop removed it); index kept in ulist[0]
            self.map.add(name, h_ulist[0])
            return h_ulist[0]
        self.map.add(name, self.count)
        self.count += 1
        return self.count - 1

    def ordered_names(self):
        out = [b""] * self.count
        for b in range(self.map.mask + 1):
            node = self.map.table[b]
            while node is not None:
                out[node.ulist[0]] = node.key
                node = node.next
        return out


class GrowLtd:
    """Growable float64 square accumulation matrices (merged dist/num).

    The reference keeps quantized cells for s/b modes; we accumulate in
    the quantized domain where it matters (dtouc conversions applied at
    the same points, merge.c:241-289)."""

    def __init__(self, dtype, bs):
        self.dtype = dtype
        self.bs = bs
        self.D = np.zeros((0, 0), np.float64)
        self.N = np.zeros((0, 0), np.float64)
        self.n = 0

    def ensure(self, n):
        if n > self.D.shape[0]:
            size = max(n, 2 * self.D.shape[0], 16)
            D = np.zeros((size, size), np.float64)
            N = np.zeros((size, size), np.float64)
            D[:self.n, :self.n] = self.D[:self.n, :self.n]
            N[:self.n, :self.n] = self.N[:self.n, :self.n]
            self.D, self.N = D, N
        self.n = max(self.n, n)


def _quant(val, dtype, bs, rnd):
    """dtouc with C double->unsigned truncation/wrap; returns the raw
    stored integer for s/b, float otherwise."""
    if dtype == "s":
        return float(int(val * bs + rnd) & 0xFFFF)
    if dtype == "b":
        return float(int(val * bs + rnd) & 0xFF)
    if dtype == "f":
        return float(np.float32(val))
    return float(val)


def main_merge(argv: list[str]) -> int:
    inputfile = "-"
    outputfile = "-"
    numfilename = None
    noutputfilename = None
    sep = "\t"
    quotes = "\0"
    precision = 9
    flag = 1
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
            elif name == "nucleotides_weights":
                numfilename = a.next_value("nucleotides_weights")
            elif name == "nucleotide_numbers":
                noutputfilename = a.next_value("nucleotide_numbers")
            elif name == "separator":
                sep = a.next_char("separator")
            elif name == "print_precision":
                precision = a.next_num("print_precision")
            elif name == "flag":
                flag = a.next_num("flag")
            elif name == "flag_help":
                flag = -1
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
                elif opt == "w":
                    numfilename = a.next_value("w")
                elif opt == "n":
                    noutputfilename = a.next_value("n")
                elif opt == "S":
                    sep = a.next_char("S")
                elif opt == "x":
                    precision = a.next_num("x")
                elif opt == "f":
                    flag = a.next_num("f")
                elif opt == "F":
                    flag = -1
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

    if flag == -1:
        sys.stdout.write("# Format flags output, add them to combine "
                         "them.\n#\n#   1:\tRelaxed Phylip\n"
                         "#   4:\tInclude template name in phylip "
                         "file\n#\n")
        return 0

    sepb = sep.encode()
    qb = quotes.encode()
    phy = PhylipStream(fileio.read_bytes(inputfile), sep=sepb, quotes=qb)
    numstream = None
    if numfilename:
        numstream = PhylipStream(fileio.read_bytes(numfilename),
                                 sep=sepb, quotes=qb)

    idx = NameIndex()
    acc = GrowLtd(dtype, bytescale)
    first = True
    while True:
        loaded = phy.load()
        if loaded is None or loaded[0] == 0:
            break
        n, flat, names, _ = loaded
        lt = LtdMatrix(flat, n, dtype, bytescale)
        if numstream is not None:
            nl = numstream.load()
            if nl is None or nl[0] != n:
                print("Distance and included nucleotides does not "
                      "concur!", file=sys.stderr)
                sys.exit(1)
            ln = LtdMatrix(nl[1], n, dtype, bytescale)
            nvals = ln.get(slice(0, n * (n - 1) // 2))
        else:
            nvals = np.ones(n * (n - 1) // 2, np.float64)
        dvals = lt.get(slice(0, n * (n - 1) // 2))

        resolved = [idx.add(names[i].data) for i in range(n)]
        acc.ensure(idx.count)

        cell = 0
        for i in range(1, n):
            m = resolved[i]
            for j in range(i):
                o = resolved[j]
                r, c = (o, m) if m < o else (m, o)
                d = dvals[cell]
                w = nvals[cell]
                if numstream is not None:
                    contrib = (d * w if (first or dtype not in "sb")
                               else _quant(d * w, dtype, bytescale, 0.5))
                    acc.D[r, c] += contrib
                else:
                    acc.D[r, c] += d
                acc.N[r, c] += w
                cell += 1
        first = False

    # normalize (normalize_ltdMatrix, merge.c:47-100)
    names_out = idx.ordered_names()
    n = idx.count
    flatD = []
    flatN = []
    for i in range(1, n):
        for j in range(i):
            w = acc.N[i, j]
            if w != 0:
                val = acc.D[i, j] / w
            else:
                val = -1.0
            if dtype in ("s", "b"):
                # stored via dtouc(val, 0.5) / dtouc(-1, 0) (merge.c:77-98)
                flatD.append(_quant(val, dtype, bytescale,
                                    0.5 if w != 0 else 0.0) / bytescale)
            else:
                flatD.append(val)
            flatN.append(w)
    out = fileio.open_out(outputfile)
    print_phy(out, n, np.asarray(flatD), names_out, flag, precision,
              comment=b"Merged")
    if numfilename and noutputfilename:
        nout = (out if noutputfilename == outputfile
                else fileio.open_out(noutputfilename))
        print_phy(nout, n, np.asarray(flatN), names_out, flag,
                  precision, comment=b"Merged")
        if nout is not out:
            fileio.close_out(nout)
    fileio.close_out(out)
    return 0
