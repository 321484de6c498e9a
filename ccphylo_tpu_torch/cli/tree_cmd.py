"""`tree` subcommand: Phylip matrices -> Newick trees (reference tree.c;
counterpart of ccphylo_tpu/cli/tree_cmd.py).

Matches the reference CLI surface (tree.c:122-470) and its output byte
for byte: one Newick line per input matrix, '>'-prefixed header when the
matrix carried a '#'-comment, timings on stderr.
"""

from __future__ import annotations

import math
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


_ENGINES = ("", "packed", "packed64", "exact", "device", "device64",
            "sharded")
_HCLUST = ("upgma", "ff", "cf", "hnj", "nj", "mn")
_SHARDED = ("dnj", "nj", "upgma")


def _engine() -> str:
    """CCPHYLO_TORCH_ENGINE: unset (the card wherever its engines are
    exact), ``device`` / ``device64`` (the reference's routing of the
    float32 / float64 device engines), ``packed`` (only -m dnj -b leaves
    the host; ``packed64`` is its alias, as in the reference),
    ``sharded`` (the row-block-sharded engines of parallel/ over the
    process group of parallel/multihost.py) or ``exact`` (the host
    engine)."""
    eng = os.environ.get("CCPHYLO_TORCH_ENGINE", "")
    if eng in _ENGINES:
        return "packed" if eng == "packed64" else eng
    raise ArgError(f'Invalid value of CCPHYLO_TORCH_ENGINE: "{eng}" '
                   "(device, device64, packed, sharded or exact).")


def _is_integer(flat) -> bool:
    fl = np.asarray(flat)
    return np.array_equal(fl, np.floor(fl))


def _packed_route(method, dtype) -> bool:
    """Whether `_route` sends a complete matrix to the packed u8 engine:
    -m dnj -b with CCPHYLO_TORCH_ENGINE unset or ``packed``.  The loader
    hands u8 cells exactly there (`form_tree`)."""
    return _engine() in ("", "packed") and method == "dnj" and dtype == "b"


def _route(flat, method, dtype, bytescale):
    """The join engine for this matrix and CCPHYLO_TORCH_ENGINE, as
    (engine, store, precision, note).

    engine: ``exact`` is the host engine (byte parity with the reference
    for every method and dtype); ``packed`` the exact-int32 u8 engine
    (tree/packed_engine.py); ``dnj`` the device DNJ engine on float
    state, or with `store` ``u16`` / ``u8`` its quantized form
    (tree/torch_engine.py); ``hclust`` the device engines of the six
    other methods (tree/hclust_engine.py).  precision is ``float32`` or
    ``float64`` for the device engines, else "".  All but ``exact`` run
    on the torch device of utils/torchconfig.py (the card unless
    CCPHYLO_TORCH_DEVICE says otherwise) and raise without it.  note is
    a line for stderr where the host engine stands in, else "".

    With the variable unset the card gets what it computes exactly, and
    only complete matrices: -m dnj -b (packed); a double-precision
    matrix of integer cells, any method (the float64 engines); -m dnj -s
    under a power-of-two ByteScale (u16 cells, float64 compute).  There
    every cell is a dyadic rational, and while cells and row sums fit
    the 53 bits of a float64 every sum is exact and its order cannot
    matter.  A join can add one fractional bit to a lineage, so the
    bound depends on the tree's depth and the dispatcher cannot test it
    on the matrix: the engines track it as they run and `_dispatch_build`
    hands a run that leaves it to the host engine.  With missing cells the
    one-sided updates store D_ik - L_i, L_i a quotient: not dyadic, and
    a parallel sum on the card may differ from the host's left-to-right
    sum in the last bit.  Those matrices, and everything else, run the
    host engine; a double-precision matrix with a note.  ``device`` and
    ``device64`` route as the reference does, and so does ``sharded``
    (float32 engines of parallel/; its host stand-ins come with a note).
    """
    eng = _engine()
    cells = np.asarray(flat)
    # u8 cells (the -b loader's) hold no missing cell and are integers
    complete = cells.dtype == np.uint8 or not (cells < 0).any()
    host = ("exact", "", "", "")
    if eng == "sharded":
        # the reference's routing, in float32 as there; its host
        # stand-ins run quietly, the port's say so
        if method in _SHARDED and dtype == "d" \
                and (complete or method == "dnj"):
            return ("sharded", method, "float32", "")
        why = "missing cells" if method in _SHARDED and dtype == "d" \
            else f"-m {method}" + ("" if dtype == "d" else f" -{dtype}")
        return host[:3] + (
            f"# ccphylo_tpu_torch: {why}: CCPHYLO_TORCH_ENGINE=sharded "
            "runs -m dnj, and -m nj / upgma on complete matrices, in "
            "double precision only; using the host engine.\n",)
    if complete and _packed_route(method, dtype):
        return ("packed", "", "", "")
    if eng in ("exact", "packed"):
        return host
    prec = "float32" if eng == "device" else "float64"
    if eng == "" and dtype == "d" \
            and not (complete and _is_integer(cells)):
        why = "missing cells" if _is_integer(cells) \
            else "non-integer distances"
        return host[:3] + (
            f"# ccphylo_tpu_torch: {why}: the device engines are "
            "byte-parity on complete integer matrices only; using the "
            "host engine (CCPHYLO_TORCH_ENGINE=device64 forces the "
            "card).\n",)
    if method in _HCLUST and dtype == "d":
        # float-scope guard: for these three the device engine's sD
        # reductions are not bitwise C sequential sums, so non-integer
        # matrices can flip exact ties (tree/hclust_engine.py)
        if method in ("ff", "hnj", "nj") and not _is_integer(cells):
            return host[:3] + (
                "# ccphylo_tpu_torch: non-integer distances with "
                f"CCPHYLO_TORCH_ENGINE={eng} -m {method}: device engine "
                "is not byte-parity on float data; using the host "
                "engine.\n",)
        return ("hclust", "", prec, "")
    if method == "dnj" and dtype == "d":
        return ("dnj", "", prec, "")
    if method == "dnj" and dtype in ("s", "b") and complete:
        if eng == "":
            # the default route keeps to exact arithmetic: u16 cells
            # under a power-of-two ByteScale (-b is the packed engine's)
            dyadic = bytescale > 0 and math.frexp(bytescale)[0] == 0.5
            return ("dnj", "u16", prec, "") if dtype == "s" and dyadic \
                else host
        return ("dnj", "u16" if dtype == "s" else "u8", prec, "")
    return host


def _engine_name(engine, store, prec) -> str:
    """``exact``, ``packed``, ``float64``, ``u16/float32``,
    ``hclust/float64``, ..."""
    if not prec:
        return engine
    if engine == "sharded":
        return f"sharded/{store}"
    head = store or ("hclust" if engine == "hclust" else "")
    return f"{head}/{prec}" if head else prec


def _dispatch_build(flat, n, names, method, flag, precision, dtype,
                    bytescale, threads=1):
    """Build the tree on the engine `_route` chooses; its name (see
    `_engine_name`) is left in `_dispatch_build.last_engine`.

    `flat` is the loaded lower triangle: float64 distances, or on the
    packed route the -b loader's uint8 cells (ByteScale applied,
    `PhylipStream.load(u8_scale=)`), which no other route takes.  The
    counter tree/host_cell_bytes adds the bytes it holds.

    On the default route the float64 engines track their exact range
    (torch_engine.track_sums): a run whose row sums leave it is handed
    to the host exact engine, which builds the tree from the loaded
    matrix, with one stderr line."""
    with timing.phase("tree/route"):
        engine, store, prec, note = _route(flat, method, dtype, bytescale)
    cells = np.asarray(flat)
    if cells.dtype == np.uint8 and engine != "packed":
        raise ValueError("u8 cells take the packed route only (-m dnj -b "
                         "on a complete matrix, CCPHYLO_TORCH_ENGINE unset "
                         "or packed)")
    timing.count("tree/host_cell_bytes", cells.nbytes)
    sys.stderr.write(note)
    _dispatch_build.last_engine = _engine_name(engine, store, prec)
    if engine in ("exact", "packed", "sharded"):
        return _build(engine, store, prec, flat, n, names, method, flag,
                      precision, dtype, bytescale, threads)
    from ..tree.torch_engine import InexactSums
    try:
        return _build(engine, store, prec, flat, n, names, method, flag,
                      precision, dtype, bytescale, threads,
                      exact_sums=_engine() == "")
    except InexactSums as e:
        sys.stderr.write(
            f"# ccphylo_tpu_torch: the {_dispatch_build.last_engine} device "
            f"engine's row sums left float64's exact range before join "
            f"{e.join}; using the host engine (CCPHYLO_TORCH_ENGINE="
            "device64 keeps the card).\n")
        _dispatch_build.last_engine = "exact"
        return build_tree(flat, n, names, method, flag, precision, dtype,
                          bytescale, threads)


def _build(engine, store, prec, flat, n, names, method, flag, precision,
           dtype, bytescale, threads, exact_sums=False):
    """The tree on `engine` (see `_route`); exact_sums: the float and
    hclust engines track their exact range and raise InexactSums."""
    if engine == "exact":
        return build_tree(flat, n, names, method, flag, precision, dtype,
                          bytescale, threads)
    if engine == "packed":
        from ..tree.packed_engine import build_tree_packed
        return build_tree_packed(flat, n, names, flag, precision,
                                 bytescale=bytescale)
    import torch
    tdt = torch.float64 if prec == "float64" else torch.float32
    if engine == "sharded":
        if method == "dnj":
            from ..parallel.sharded_dnj import build_tree_sharded_dnj
            return build_tree_sharded_dnj(flat, n, names, flag, precision,
                                          dtype=tdt)
        from ..parallel.sharded_nj import build_tree_sharded
        from ..tree.torch_engine import square_matrix
        return build_tree_sharded(square_matrix(flat, n, 0.0), n, names,
                                  method, flag, precision, dtype=tdt)
    if engine == "hclust":
        from ..tree.hclust_engine import build_tree_hclust
        return build_tree_hclust(flat, n, names, method=method, flag=flag,
                                 precision=precision, dtype=tdt,
                                 exact_sums=exact_sums)
    if store:
        from ..tree.torch_engine import build_tree_q
        return build_tree_q(flat, n, names, flag, precision,
                            bytescale=bytescale, store=store,
                            compute_dtype=tdt, exact_sums=exact_sums)
    from ..tree.torch_engine import build_tree_float
    # the batch scan is trajectory-exact (ties included); float64 state
    # makes it bit-exact against the reference wherever the C's own
    # float64 sums are reproduced
    return build_tree_float(flat, n, names, flag, precision, dtype=tdt,
                            scan="batch", exact_sums=exact_sums)


def form_tree(inputfile, outputfile, flag, sep, quotes, method, precision,
              dtype, bytescale, threads=1) -> int:
    """formTree (tree.c:37-120)."""
    data = fileio.read_bytes(inputfile)
    stream = PhylipStream(data, sep=sep.encode(), quotes=quotes.encode())
    # the packed route takes the loader's u8 cells, one byte a cell on
    # the host (a matrix with a missing cell loads as float64)
    u8_scale = bytescale if _packed_route(method, dtype) else None
    out = fileio.open_out(outputfile)
    t0 = time.process_time()
    while True:
        loaded = stream.load(u8_scale)
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
