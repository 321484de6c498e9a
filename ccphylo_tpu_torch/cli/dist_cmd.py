"""`dist` subcommand: KMA .mat / fasta alignments -> Phylip distance
matrices (reference dist.c, cdist.c, ltdmatrix[thrd].c, fsacmp[thrd].c;
counterpart of ccphylo_tpu/cli/dist_cmd.py).

Routes (makeMatrix, dist.c:42-329):
- multiple files + -r reference      -> one ltd matrix (mat or fasta)
- <2 files, '#' input                -> .union stream, one matrix per
                                        shared template
- <2 files, '>' input                -> MSA mode (records of one fasta)
- -a addfile                         -> append one row to an existing
                                        Phylip matrix (add2Matrix,
                                        dist.c:331-411)

The all-pairs SNP fills of fasta input (`_batch_shared`,
`_batch_pairwise`) run on the torch device of utils/torchconfig.py
(default ``cuda``) through ops/snp_torch.py; CCPHYLO_TORCH_DIST=host
asks for the numpy kernels of ops/snp.py instead.  Integer counts are
identical either way.

`.mat` input (`_mat_device_spec`): the all-pairs metric table of
ops/matdist_torch.py runs on the torch device for the metrics whose
float64 sums it computes exactly, whatever their order (-d l1, linf, z:
bytes equal to the host's); every other metric runs the host metrics
of ops/veccmp.py, with one stderr line naming the variable that forces
the device.  CCPHYLO_TORCH_DIST=device sends every metric the table
knows to the device in float64 (sums in the device's order: ~1e-12 of
the host's, not byte parity); CCPHYLO_TORCH_DIST=host keeps all of them
on the host.  The device route scores its pairs once every file is
loaded; stderr keeps the host route's order of lines, and an exit at a
sample that falls short once stripped comes after all files were read.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..io import fileio, kma
from ..utils import timing
from ..io.phylip import (print_phy, print_phy_update, get_size_phy,
                         get_filenames_phy)
from ..ops import pack2bit, snp
from ..ops.snp_torch import (_snp_matrix, _snp_matrix_pairwise,
                             inc32_to_pairmask, padded_rows, u32_tensor)
from ..ops.matdist_torch import (EXACT_METRICS, cmp_mats_from_table,
                                 pair_table, resolve_metric)
from ..ops.veccmp import get_veccmp, cmp_mats
from ..utils.torchconfig import device
from .args import Args, ArgError

HELP = """\
#CCPhylo dist calculates distances between samples based on overlaps between nucleotide count matrices created by e.g. KMA.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file(s)                   \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -n, --nucleotide_numbers\tOutput number of nucleotides included\tFalse/None
#    -S, --separator       \tSeparator                       \t\\t
#    -x, --print_precision \tFloating point print precision  \t9
#    -y, --methylation_motifs\tMask methylation motifs from <file>\tFalse/None
#    -V, --nucleotide_variations\tOutput nucleotide variations \tFalse/None
#    -r, --reference       \tTarget reference                \tNone
#    -a, --add             \tAdd file to existing matrix     \t
#    -E, --min_depth       \tMinimum depth                   \t15
#    -C, --min_cov         \tMinimum coverage                \t50.0%
#    -L, --min_len         \tMinimum overlapping length      \t1
#    -W, --normalization_weight\tNormalization weight         \t0 / None
#    -P, --proximity       \tMinimum proximity between SNPs  \t0
#    -f, --flag            \tOutput flags                    \t1
#    -F, --flag_help       \tHelp on option "-f"             \t
#    -d, --distance        \tDistance method                 \tcos
#    -D, --distance_help   \tHelp on option "-d"             \t
#    -l, --significance_lvl\tMinimum lvl. of signifiacnce    \t0.05
#    -p, --float_precision \tFloat precision on distance matrix\tdouble
#    -s, --short_precision \tShort precision on distance matrix\tdouble / 1e0
#    -b, --byte_precision  \tByte precision on distance matrix\tdouble / 1e0
#    -H, --mmap            \tAllocate matrix on the disk     \tFalse
#    -T, --tmp             \tSet directory for temporary files\t
#    -t, --threads         \tNumber of threads               \t1
#    -h, --help            \tShows this helpmessage          \t
"""

FLAG_HELP = """\
# Format flags output, add them to combine them.
#
#   1:\tRelaxed Phylip
#   2:\tDistances are pairwise, always true on *.mat files
#   4:\tInclude template name in phylip file
#   8:\tInclude insignificant bases in distance calculation, only affects fasta input
#  16:\tDistances based on fasta input
#  32:\tDo not include insignificant bases in pruning
#
"""

DIST_HELP = """\
# Distance calculation methods:
#
# cos:\tCalculate distance between positions as the angle between the count vectors.
# z:\tMake consensus comparison if vectors passes a McNemar test
# chi2:\tCalculate the chi square distance
# nchi2:\tCalculate the normalized chi square distance
# c:\tCalculate the Clausen distance between the count vectors. d(A,B) = (||A-B||_1 / sum(max{Ai, Bi}))
# nc:\tCalculate the normalized Clausen distance between the count vectors.
# bc:\tCalculate the Bray-Curtis dissimilarity between the count vectors.
# nbc:\tCalculate the normalized Bray-Curtis dissimilarity between the count vectors.
# ln:\tCalculate distance between positions as the n-norm distance between the count vectors. Replace "n" with the waned norm
# linf:\tCalculate distance between positions as the l_infinity distance between the count vectors.
# nln:\tCalculate distance between positions as the normalized n-norm distance between the count vectors. Replace last "n" with the waned norm
# nlinf:\tCalculate distance between positions as the normalized l_infinity distance between the count vectors.
#
"""


class QuantCells:
    """Accumulates matrix cells with the reference dtype conversions;
    yields the logical (printable) float64 values.

    With ``mmap_dir`` set (dist -H / -T, reference ltdMatrixMinit
    matrix.c:116-231), cells stream to an unlinked temp file instead of
    RAM — n(n-1)/2 float64 cells never build up in the heap."""

    def __init__(self, dtype: str, bytescale: float,
                 mmap_dir: str | None = None):
        self.dtype = dtype
        self.bs = bytescale
        self.vals: list[float] = []
        self._disk = None
        self._count = 0
        if mmap_dir is not None:
            import tempfile
            self._disk = tempfile.TemporaryFile(dir=mmap_dir or None)

    def _flush(self):
        if self._disk is not None and self.vals:
            self._disk.write(
                np.asarray(self.vals, np.float64).tobytes())
            self._count += len(self.vals)
            self.vals.clear()

    def add(self, val: float, rnd: float = 0.5):
        dt = self.dtype
        if dt == "d":
            self.vals.append(float(val))
        elif dt == "f":
            self.vals.append(float(np.float32(val)))
        else:
            npdt = np.uint16 if dt == "s" else np.uint8
            stored = np.float64(val) * self.bs + rnd
            with np.errstate(invalid="ignore"):
                q = npdt(np.int64(stored)) if np.isfinite(stored) else npdt(0)
            self.vals.append(float(q) / self.bs)
        if self._disk is not None and len(self.vals) >= 65536:
            self._flush()

    def add_many(self, vals, rnd: float = 0.5):
        """Vectorized add() — same per-cell dtype conversions."""
        vals = np.asarray(vals, np.float64)
        dt = self.dtype
        if dt == "d":
            self.vals.extend(vals.tolist())
        elif dt == "f":
            self.vals.extend(
                vals.astype(np.float32).astype(np.float64).tolist())
        else:
            npdt = np.uint16 if dt == "s" else np.uint8
            stored = vals * self.bs + rnd
            with np.errstate(invalid="ignore"):
                q = np.where(np.isfinite(stored), stored, 0) \
                    .astype(np.int64).astype(npdt)
            self.vals.extend((q.astype(np.float64) / self.bs).tolist())
        if self._disk is not None and len(self.vals) >= 65536:
            self._flush()

    def array(self):
        if self._disk is not None:
            self._flush()
            self._disk.flush()
            if self._count == 0:
                return np.empty(0, np.float64)
            # -H stays disk-backed through printing: a read-only memmap
            # over the unlinked temp file (the reference's mmap matrix
            # walks rows from disk during printphy, matrix.c:116 +
            # phy.c:59-123); print_phy slices it row by row, so peak
            # RSS is page cache, not a dense n(n-1)/2 float64 block.
            return np.memmap(self._disk, dtype=np.float64, mode="r",
                             shape=(self._count,))
        return np.asarray(self.vals, np.float64)


def main_dist(argv: list[str]) -> int:
    precision = 9
    dtype = "d"
    filenames: list[str] = []
    flag = 1
    norm = 0
    min_depth = 15
    min_length = 1
    proxi = 0
    target = None
    addfilename = None
    outputfilename = "-"
    noutputfilename = None
    methfilename = None
    diffilename = None
    min_cov = 0.5
    alpha = 0.05
    threads = 1
    use_mmap = False
    tmpdir = ""
    method = "cos"
    bytescale = 1.0
    sep = "\t"

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
                while a.i + 1 < len(a.argv) and not a.argv[a.i + 1].startswith("-"):
                    filenames.append(a.next_value("input"))
            elif name == "output":
                outputfilename = a.next_value("output")
            elif name == "nucleotide_numbers":
                noutputfilename = a.next_value("nucleotide_numbers")
            elif name == "separator":
                sep = a.next_char("separator")
            elif name == "print_precision":
                precision = a.next_num("print_precision")
            elif name == "methylation_motifs":
                methfilename = a.next_value("methylation_motifs")
            elif name == "nucleotide_variations":
                diffilename = a.next_value("nucleotide_variations")
            elif name == "reference":
                target = a.next_value("reference")
            elif name == "add":
                addfilename = a.next_value("add")
            elif name == "min_depth":
                min_depth = int(a.next_float("min_depth"))
            elif name == "min_cov":
                min_cov = a.next_float("min_cov") / 100
            elif name == "min_len":
                min_length = a.next_num("min_len")
            elif name == "normalization_weight":
                norm = a.next_num("normalization_weight")
            elif name == "proximity":
                proxi = a.next_num("proximity")
            elif name == "flag":
                flag = a.next_num("flag")
            elif name == "flag_help":
                flag = -1
            elif name == "distance":
                method = a.next_value("distance")
            elif name == "distance_help":
                method = None
            elif name == "significance_lvl":
                alpha = a.next_float("significance_lvl")
            elif name == "float_precision":
                dtype = "f"
            elif name == "short_precision":
                dtype = "s"
                bytescale = a.opt_float(bytescale)
            elif name == "byte_precision":
                dtype = "b"
                bytescale = a.opt_float(bytescale)
            elif name == "mmap":
                use_mmap = True
            elif name == "tmp":
                tmpdir = a.next_value("tmp")
            elif name == "threads":
                threads = a.next_num("threads")
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
                    outputfilename = a.next_value("o")
                elif opt == "n":
                    noutputfilename = a.next_value("n")
                elif opt == "S":
                    sep = a.next_char("S")
                elif opt == "x":
                    precision = a.next_num("x")
                elif opt == "y":
                    methfilename = a.next_value("y")
                elif opt == "V":
                    diffilename = a.next_value("V")
                elif opt == "r":
                    target = a.next_value("r")
                elif opt == "a":
                    addfilename = a.next_value("a")
                elif opt == "E":
                    min_depth = int(a.next_float("E"))
                elif opt == "C":
                    min_cov = a.next_float("C") / 100
                elif opt == "L":
                    min_length = a.next_num("L")
                elif opt == "W":
                    norm = a.next_num("W")
                elif opt == "P":
                    proxi = a.next_num("P")
                elif opt == "f":
                    flag = a.next_num("f")
                elif opt == "F":
                    flag = -1
                elif opt == "d":
                    method = a.next_value("d")
                elif opt == "D":
                    method = None
                elif opt == "l":
                    alpha = a.next_float("l")
                elif opt == "p":
                    dtype = "f"
                elif opt == "s":
                    dtype = "s"
                    bytescale = a.opt_float(bytescale)
                elif opt == "b":
                    dtype = "b"
                    bytescale = a.opt_float(bytescale)
                elif opt == "H":
                    use_mmap = True
                elif opt == "T":
                    tmpdir = a.next_value("T")
                elif opt == "t":
                    threads = a.next_num("t")
                elif opt == "h":
                    sys.stdout.write(HELP)
                    return 0
                else:
                    raise ArgError(f'Unknown argument or option: "{opt}"')
        else:
            filenames.append(arg)
        a.i += 1

    if min_cov < 0 or 1 < min_cov:
        raise ArgError('Invalid value parsed at "--min_cov".')
    if bytescale == 0:
        raise ArgError('Invalid value parsed at "--short_precision".')
    if alpha < 0:
        raise ArgError('Invalid value parsed at "--significance_lvl".')
    if flag == -1:
        sys.stdout.write(FLAG_HELP)
        return 0
    if method is None:
        sys.stdout.write(DIST_HELP)
        return 0
    veccmp = get_veccmp(method, alpha)
    if veccmp is None:
        raise ArgError('Invalid value parsed at "-d".')

    incvariant = ("insigprune" if flag & 32 else
                  "insig" if flag & 8 else "default")

    cfg = dict(flag=flag, norm=norm, min_depth=min_depth,
               min_length=min_length, min_cov=min_cov, proxi=proxi,
               veccmp=veccmp, method=method, dtype=dtype,
               bytescale=bytescale, precision=precision,
               incvariant=incvariant, methfilename=methfilename,
               diffilename=diffilename,
               noutputfilename=noutputfilename, sep=sep,
               threads=max(int(threads), 1),
               mmap_dir=(tmpdir if use_mmap else None), alpha=alpha)

    if addfilename and filenames:
        return add2matrix(filenames[0], addfilename, outputfilename,
                          target, cfg)
    return make_matrix(filenames, outputfilename, target, cfg)


# ---------------------------------------------------------------------------


def _open_diffile(diffilename, outfile, outputfilename):
    if not diffilename:
        return None
    if diffilename == outputfilename:
        return outfile
    return fileio.open_out(diffilename)


def make_matrix(filenames, outputfilename, target, cfg) -> int:
    flag = cfg["flag"]
    num_file = len(filenames)
    if not num_file and target:
        num_file = 1

    # determine input format (dist.c:97-110)
    if flag & 16:
        informat = ">"
    elif num_file and filenames:
        head = fileio.read_bytes(filenames[0])[:1]
        informat = ">" if head == b">" else "#"
    else:
        informat = "#"

    out = fileio.open_out(outputfilename)
    nout = None
    if cfg["noutputfilename"]:
        if cfg["noutputfilename"] == outputfilename:
            nout = out
        else:
            nout = fileio.open_out(cfg["noutputfilename"])
    diff = _open_diffile(cfg["diffilename"], out, outputfilename)

    if target and num_file > 1:
        include = [1] * num_file
        if informat == "#":
            cells, ncells, include = mat_pairwise_matrix(
                filenames, target.encode(), include, cfg)
        else:
            cells, ncells, include = fsa_matrix(
                filenames, target.encode(), include, cfg, diff)
        n_inc = sum(1 for x in include if x)
        names = [f.encode() for f in filenames]
        if n_inc > 1:
            print_phy(out, n_inc, cells.array(), names, flag,
                      cfg["precision"], include, target.encode())
            if nout is not None and ncells is not None and n_inc > 1:
                print_phy(nout, n_inc, ncells.array(), names, flag,
                          cfg["precision"], include, target.encode())
    elif num_file < 2 and informat == "#":
        union_matrices(filenames, out, nout, cfg, diff)
    elif num_file < 2:
        msa_matrix(filenames, out, nout, cfg, diff)
    else:
        print("Invalid argument combination.", file=sys.stderr)
        return 1

    if diff is not None and diff is not out:
        fileio.close_out(diff)
    fileio.close_out(out)
    if nout is not None and nout is not out:
        fileio.close_out(nout)
    return 0


def _pair_map(threads: int, fn, js):
    """Compute fn(j) for every j — in a thread pool under dist -t
    (ltdmatrixthrd.c:182-376's pthread cell workers; numpy/zlib release
    the GIL) — and yield (j, result) in ascending-j order so sentinel
    handling and stderr messages stay byte-deterministic regardless of
    thread count (the reference guarantees result determinism the same
    way: each cell is independent, only the cursor is shared)."""
    js = list(js)
    if threads <= 1 or len(js) <= 1:
        for j in js:
            yield j, fn(j)
        return
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=threads) as pool:
        for j, res in zip(js, pool.map(fn, js)):
            yield j, res


def mat_pairwise_matrix(filenames, target, include, cfg):
    """ltdMatrixThrd (ltdmatrixthrd.c:376-562): .mat multi-file matrix."""
    min_depth = cfg["min_depth"]
    min_length = cfg["min_length"]
    min_cov = cfg["min_cov"]
    D = QuantCells(cfg["dtype"], cfg["bytescale"],
                   mmap_dir=cfg.get("mmap_dir"))
    N = QuantCells(cfg["dtype"], cfg["bytescale"],
                   mmap_dir=cfg.get("mmap_dir"))
    stripped = {}
    # batched table on the torch device for the metrics routed there:
    # the pairs of sample i wait for the table, and so does every load
    # message after them, so that stderr reads as on the host route
    # (an exit at a -2 pair then comes after all files were read)
    dev_spec = _mat_device_spec(cfg)
    device_pairs = [] if dev_spec is not None else None

    def say(msg):
        if device_pairs:
            device_pairs.append(msg)
        else:
            print(msg, file=sys.stderr)

    def load(i):
        tm = kma.load_mat_template(filenames[i], target)
        if tm is None:
            say(f'Template ("{target.decode()}") is not included in:\t'
                f"{filenames[i]}")
        return tm

    # find first valid matrix (ltdmatrixthrd.c:417-465): validated on
    # insertion-stripped rows
    i = 0
    first = -1
    while i < len(filenames):
        ok = False
        if include[i]:
            tm = load(i)
            if tm is None:
                include[i] = 0
            else:
                s = tm.stripped()
                n = s.n_nucs(min_depth)
                if n < min_length or n < min_cov * s.length:
                    print(f'Template ("{target.decode()}") did not exceed '
                          f"threshold for inclusion:\t{filenames[i]}",
                          file=sys.stderr)
                    include[i] = 0
                else:
                    stripped[i] = s
                    ok = True
        i += 1
        if ok:
            first = i - 1
            break

    # remaining samples: validated on unstripped rows (FileBuffLoadMat)
    while i < len(filenames):
        if include[i]:
            tm = load(i)
            if tm is None:
                include[i] = 0
            elif (tm.n_nucs(min_depth) < min_length
                  or tm.n_nucs(min_depth) < min_cov * tm.length):
                say(f'Template ("{target.decode()}") did not exceed '
                    f"threshold for inclusion:\t{filenames[i]}")
                include[i] = 0
            else:
                mat1 = tm.stripped()
                stripped[i] = mat1
                if device_pairs is None:
                    def one(j, mat1=mat1):
                        mat2 = stripped[j]
                        return cmp_mats(
                            mat1.counts, mat1.totals, mat2.counts,
                            mat2.totals, cfg["norm"], min_depth,
                            min_length, min_cov, cfg["veccmp"])

                    js = [j for j in range(i) if include[j]]
                    for j, (dist, rinc) in _pair_map(
                            cfg.get("threads", 1), one, js):
                        _emit_mat_pair(D, N, dist, rinc, target,
                                       filenames, i, j)
                else:
                    device_pairs.append(i)
        i += 1

    if device_pairs is not None:
        # one table over all included pairs; gates and rows_inc are
        # integer-exact, the sums are the device's
        table = _mat_table(dev_spec, stripped, sorted(stripped), min_depth)
        for i in device_pairs:
            if isinstance(i, str):  # a load message, in its place
                print(i, file=sys.stderr)
                continue
            for j in range(i):
                if include[j]:
                    dist, rinc = _mat_pair_from_table(
                        table, i, j, stripped[i], stripped[j], cfg)
                    _emit_mat_pair(D, N, dist, rinc, target, filenames,
                                   i, j)
    return D, N, include


def _mat_table(dev_spec, stripped, order, min_depth):
    """The all-pairs metric table of ops/matdist_torch.py over the
    stripped samples `order` (ascending: a pair (i, j), j < i, reads the
    strict lower triangle), on the torch device."""
    pos_of = {s: a for a, s in enumerate(order)}
    S, R = pair_table(dev_spec, [stripped[s].counts for s in order],
                      [stripped[s].totals for s in order], min_depth,
                      device=device(), lower=True)
    nnucs = {s: stripped[s].n_nucs(min_depth) for s in order}
    return S, R, pos_of, nnucs


def _mat_pair_from_table(table, i, j, mat1, mat2, cfg):
    """cmp_mats' (dist, rows_inc) of samples i (mat1) and j (mat2) from
    `_mat_table`'s table."""
    S, R, pos_of, nnucs = table
    if mat2.length > mat1.length:
        # cmpMats' 'sample2 longer' sentinel: N = the total of the first
        # overflowing row (matcmp.c:469-471)
        return -1.0, int(mat2.totals[mat1.length])
    return cmp_mats_from_table(
        S, R, pos_of[i], pos_of[j], mat1.length, mat2.length, nnucs[j],
        cfg["norm"], cfg["min_depth"], cfg["min_length"], cfg["min_cov"])


def _emit_mat_pair(D, N, dist, rinc, target, filenames, i, j):
    """Shared sentinel/message handling for one .mat pair
    (ltdmatrixthrd.c result handling)."""
    if dist == -2.0:
        print(f'Template ("{target.decode()}") did not '
              "exceed threshold for inclusion:\t"
              f"{filenames[j]}", file=sys.stderr)
        sys.exit(1)
    if dist == -1.0:
        print("No sufficient overlap between samples:\t"
              f"{filenames[i]}\t{filenames[j]}", file=sys.stderr)
    D.add(dist)
    N.add(rinc)


def _fsa_load_samples(filenames, target, include, cfg, union_mode=False):
    """ltdFsaMatrix_get's load/mask phase (cdist.c:36-168).

    Decompress + translate + 2-bit pack run per-sample in a thread
    pool (zlib/numpy release the GIL); the mask derivation stays
    sequential — get_inc_pos's insignificance clears mutate the shared
    reference codes, so mask order is semantically load order
    (fsacmp.c:202-206)."""
    flag = cfg["flag"]
    pair = bool(flag & 2)
    trans = pack2bit.get_2bit_table(flag)
    motifs = []
    if cfg["methfilename"]:
        motifs = pack2bit.parse_meth_motifs(
            fileio.read_bytes(cfg["methfilename"]))
    length = 0
    min_length = cfg["min_length"]
    ref = None
    seqs = [None] * len(filenames)
    includes = [None] * len(filenames)
    shared_inc = None

    def _prefetch(fn):
        data = fileio.read_bytes(fn)
        if data[:1] != b">":
            return "notfasta", None, None, None
        seq = kma.load_fasta_seq(data, target, trans)
        if seq is None:
            return "missing", None, None, None
        packed, ns = pack2bit.pack_2bit(seq)
        return "ok", seq, packed, ns

    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1))
    inc_order = [i for i in range(len(filenames)) if include[i]]
    # bounded window: peak RSS stays O(window * sample), and an error
    # exit waits on at most `window` queued loads
    window = 64
    futs: dict = {}
    submitted = 0

    def _fill_window(consumed: int):
        nonlocal submitted
        while submitted < len(inc_order) and submitted < consumed + window:
            k = inc_order[submitted]
            futs[k] = pool.submit(_prefetch, filenames[k])
            submitted += 1

    _fill_window(0)
    consumed_n = 0

    for i, fn in enumerate(filenames):
        if not include[i]:
            continue
        status, seq, packed_pre, ns_pre = futs.pop(i).result()
        consumed_n += 1
        _fill_window(consumed_n)
        if status == "notfasta":
            print(f'"{fn}" is not fasta.', file=sys.stderr)
            sys.exit(1)
        if status == "missing":
            seq = None
        if seq is None:
            print(f'Missing template entry ("{target.decode()}") in '
                  f"file:\t{fn}", file=sys.stderr)
            include[i] = 0
            continue
        if ref is not None:
            if len(seq) != length:
                print(f"Sequences does not match: {fn}", file=sys.stderr)
                sys.exit(1)
            if pair:
                inc = pack2bit.init_inc_pos(length)
                packed = packed_pre
                pack2bit.mask_motifs(packed, inc, length, motifs)
                pack2bit.get_inc_pos(inc, seq, seq, cfg["proxi"],
                                     cfg["incvariant"])
                n_inc = snp.get_npos(inc)
                if n_inc < min_length:
                    print(f"# Excluded:\t{fn}\t( {n_inc} / {length} )",
                          file=sys.stderr)
                    include[i] = 0
                else:
                    print(f"# Included:\t{fn}\t( {n_inc} / {length} )",
                          file=sys.stderr)
                    seqs[i] = packed
                    includes[i] = inc
            else:
                packed, ns = packed_pre, ns_pre
                n_inc = length - ns
                if n_inc < min_length:
                    print(f"# Excluded:\t{fn}\t( {n_inc} / {length} )",
                          file=sys.stderr)
                    include[i] = 0
                else:
                    print(f"# Included:\t{fn}\t( {n_inc} / {length} )",
                          file=sys.stderr)
                    seqs[i] = packed
                    pack2bit.mask_motifs(packed, shared_inc, length, motifs)
                    pack2bit.get_inc_pos(shared_inc, seq, ref,
                                         cfg["proxi"], cfg["incvariant"])
        else:
            length = len(seq)
            if min_length < min_cov_len(cfg["min_cov"], length):
                min_length = min_cov_len(cfg["min_cov"], length)
            inc = pack2bit.init_inc_pos(length)
            packed = packed_pre
            pack2bit.mask_motifs(packed, inc, length, motifs)
            pack2bit.get_inc_pos(inc, seq, seq, cfg["proxi"],
                                 cfg["incvariant"])
            n_inc = snp.get_npos(inc)
            if n_inc < min_length:
                print(f"# Excluded:\t{fn}\t( {n_inc} / {length} )",
                      file=sys.stderr)
                include[i] = 0
            else:
                print(f"# Included:\t{fn}\t( {n_inc} / {length} )",
                      file=sys.stderr)
                seqs[i] = packed
                includes[i] = inc
                if not pair:
                    shared_inc = inc
                ref = seq
    pool.shutdown(wait=False)
    return seqs, includes, shared_inc, length, min_length, include


def min_cov_len(min_cov: float, length: int) -> int:
    """minLength = minCov * len with C unsigned truncation
    (cdist.c:116)."""
    return int(min_cov * length)


def fsa_matrix(filenames, target, include, cfg, diff, headers=None):
    """ltdFsaMatrix_get distance phase (cdist.c:170-194 →
    cmpFsaThrd/cmpairFsaThrd, fsacmpthrd.c:108-480)."""
    pair = bool(cfg["flag"] & 2)
    (seqs, includes, shared_inc, length, min_length,
     include) = _fsa_load_samples(filenames, target, include, cfg)
    D = QuantCells(cfg["dtype"], cfg["bytescale"],
                   mmap_dir=cfg.get("mmap_dir"))
    N = QuantCells(cfg["dtype"], cfg["bytescale"],
                   mmap_dir=cfg.get("mmap_dir"))
    norm = cfg["norm"]
    n_inc = sum(1 for x in include if x)
    if not n_inc:
        print("All sequences were trimmed away.", file=sys.stderr)
        return D, None, [0] * len(include)
    idxs = [i for i in range(len(filenames)) if include[i]]
    if pair:
        # batched all-pairs kernel when no per-pair proximity re-masking
        # or SNP listing is needed (identical integer counts)
        batched = None
        if diff is None and cfg["proxi"] == 0 and len(idxs) > 2:
            batched = _batch_pairwise(seqs, includes, idxs)
        for a, i in enumerate(idxs):
            for b in range(a):
                j = idxs[b]
                if batched is None:
                    pinc = snp.mask_proxi(includes[i], includes[j],
                                          seqs[i], seqs[j], length,
                                          cfg["proxi"])
                    if diff is not None:
                        _print_diffs(diff, i, j, seqs[i], seqs[j], pinc,
                                     length)
                    dist, inc = snp.fsacmpair(seqs[i], seqs[j], pinc)
                else:
                    dist = int(batched[0][a, b])
                    inc = int(batched[1][a, b])
                if min_length <= inc:
                    if norm:
                        D.add(dist * norm / inc)
                    else:
                        D.add(float(dist))
                else:
                    D.add(-1.0, rnd=0.0)
                N.add(float(inc))
        return D, N, include
    # shared mask
    inc_global = snp.get_npos(shared_inc)
    print(f"# {inc_global} / {length} bases included in distance matrix.",
          file=sys.stderr)
    nfactor = (norm / inc_global) if norm else 1.0
    if diff is None and len(idxs) > 2:
        k = len(idxs)
        with timing.phase("dist/pairwise_fill", items=k * (k - 1) / 2):
            Dint = _batch_shared(seqs, idxs, shared_inc)
        for a in range(1, len(idxs)):
            D.add_many(nfactor * Dint[a, :a].astype(np.float64))
        return D, None, include
    for i in range(len(filenames)):
        if not include[i]:
            continue
        for j in range(i):
            if not include[j]:
                continue
            if diff is not None:
                _print_diffs(diff, i, j, seqs[i], seqs[j], shared_inc,
                             length)
            dist = snp.fsacmp(seqs[i], seqs[j], shared_inc)
            D.add(nfactor * dist)
    return D, None, include


def _use_device() -> bool:
    return os.environ.get("CCPHYLO_TORCH_DIST", "") != "host"


def _mat_device_spec(cfg):
    """The metric spec of ops/matdist_torch.py when `.mat` distances of
    cfg["method"] run on the torch device, else None (the host metrics).
    With CCPHYLO_TORCH_DIST unset the device gets the metrics whose
    bytes it reproduces (EXACT_METRICS); another metric it knows stays
    on the host, and one stderr line per run (noted in `cfg`) says how
    to force it."""
    mode = os.environ.get("CCPHYLO_TORCH_DIST", "")
    if mode == "host":
        return None
    spec = resolve_metric(cfg["method"], cfg.get("alpha", 0.05))
    if spec is None:
        return None
    if mode == "device" or cfg["method"] in EXACT_METRICS:
        return spec
    if not cfg.get("mat_noted"):
        cfg["mat_noted"] = True
        print(f"# ccphylo_tpu_torch: -d {cfg['method']} on .mat input "
              "runs the host metrics (its float sums depend on their "
              "order); CCPHYLO_TORCH_DIST=device forces the card, within "
              "~1e-12 of these cells", file=sys.stderr)
    return None


def _batch_shared(seqs, idxs, shared_inc):
    """All-pairs SNP counts for the included samples under the shared
    mask: the int8 Gram of ops/snp_torch.py on the torch device, or the
    numpy XOR-popcount under CCPHYLO_TORCH_DIST=host.  Integer counts
    are identical either way.

    CCPHYLO_TORCH_DIST_CKPT=<dir> computes the fill tile-by-tile on the
    host with each finished tile persisted; a restarted run recomputes
    only missing tiles (utils/checkpoint.py).  It and the host route
    stack the samples into one array.

    On the device no array of all samples is made on the host: each
    sample's u64 words are copied from the loader's array into one
    padded int64 buffer on the card (`padded_rows`: a ring of pinned
    host blocks on CUDA), which the expansion kernel reads in place;
    only the shared include words are converted on the host, to a pair
    mask.

    Its device spans (utils/timing.py), each once a fill, in order:
    dist/stack (the rows copied into the ring's slots and the slots'
    copies enqueued), dist/convert (the pair mask of the shared include
    words), dist/upload (the mask's copy and the wait for the ring's
    last block), dist/kernels (`_snp_matrix`: the expansion and Gram
    launches and its host read of the mask) and dist/copy_back (the
    wait for the last kernel and the counts' copy).  The counters
    dist/u64_fills and dist/direct_fills count the device fills whose
    words went up unconverted, straight into the padded buffer."""
    ck_dir = os.environ.get("CCPHYLO_TORCH_DIST_CKPT")
    if _use_device() and not ck_dir:
        dev = device()
        with timing.phase("dist/stack"):
            s64 = padded_rows([seqs[i] for i in idxs], dev)
        with timing.phase("dist/convert"):
            pm = inc32_to_pairmask(shared_inc)
        with timing.phase("dist/upload"):
            pm = u32_tensor(pm, dev)
            _drain(dev)
        timing.count("dist/u64_fills")
        timing.count("dist/direct_fills")
        with timing.phase("dist/kernels"):
            C = _snp_matrix(s64, pm, len(idxs))
        with timing.phase("dist/copy_back"):
            return C.cpu().numpy()
    with timing.phase("dist/stack"):
        S = np.stack([seqs[i] for i in idxs])
    if ck_dir:
        from ..utils.checkpoint import BlockCheckpoint, fingerprint_arrays
        bc = BlockCheckpoint(ck_dir, len(idxs),
                             fingerprint_arrays([S, shared_inc]))
        return bc.fill(lambda si, sj:
                       snp.cross_block(S[si], S[sj], shared_inc))
    return snp.pairwise_shared(S, shared_inc)


def _batch_pairwise(seqs, includes, idxs):
    """All-pairs (dist, shared) with per-sample masks (proxi == 0); the
    spans and counters of `_batch_shared`.  On the device both the u64
    words and the samples' u32 include words go from the loader's
    arrays into padded buffers on the card (`padded_rows`, words then
    include words, both in dist/stack), as the loader hands them (the
    expansion kernel reads an include word per u64 word in place);
    dist/convert holds only the include words' view as u32 rows (no
    copy), dist/upload only the wait for the ring's last block.  The
    counter dist/inc_word_fills counts the device fills whose masks went
    up as include words.  The host route stacks both."""
    if _use_device():
        dev = device()
        with timing.phase("dist/convert"):
            incs = [np.asarray(includes[i], np.uint32) for i in idxs]
        with timing.phase("dist/stack"):
            s64 = padded_rows([seqs[i] for i in idxs], dev)
            inc = padded_rows(incs, dev)
        with timing.phase("dist/upload"):
            _drain(dev)
        timing.count("dist/u64_fills")
        timing.count("dist/inc_word_fills")
        timing.count("dist/direct_fills")
        with timing.phase("dist/kernels"):
            D, N = _snp_matrix_pairwise(s64, inc, len(idxs))
        with timing.phase("dist/copy_back"):
            return D.cpu().numpy(), N.cpu().numpy()
    with timing.phase("dist/stack"):
        S = np.stack([seqs[i] for i in idxs])
        I = np.stack([includes[i] for i in idxs])
    return snp.pairwise_masked(S, I)


def _drain(dev) -> None:
    """Wait for the work queued on the device's stream: there, the
    ring's last block of `padded_rows`."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _print_diffs(diff, i, j, seq1, seq2, inc, length):
    bases = b"ACGT"
    for pos, b1, b2 in snp.diff_positions(seq1, seq2, inc, length):
        diff.write(b"(%d, %d)\t%c%d%c\n"
                   % (i, j, bases[b1], pos, bases[b2]))


def union_matrices(filenames, out, nout, cfg, diff) -> None:
    """Union-stream mode (dist.c:181-279): one matrix per shared
    template."""
    flag = cfg["flag"]
    data = fileio.read_bytes(filenames[0] if filenames else "-")
    names, pos = kma.parse_union_header(data)
    if names is None:
        print("Malformed union input.", file=sys.stderr)
        sys.exit(1)
    num_file = len(names)
    # resolve file suffixes (dist.c:222-250)
    suffix = ".fsa.gz" if flag & 16 else ".mat.gz"
    files = []
    for nm in names:
        base = nm.decode()
        dot = base.rfind(".")
        if dot >= 0:
            base = base[:dot]
        fn = base + suffix
        if not os.path.exists(fn):
            fn = fn[:-3]
        files.append(fn)

    for target, idxs in kma.iter_union_entries(data, pos):
        include = [0] * num_file
        for ix in idxs:
            include[ix] = 1
        if flag & 16:
            D, N, include = fsa_matrix(files, target, include, cfg, diff)
        else:
            D, N, include = mat_union_matrix(files, target, include, cfg)
        n_inc = sum(1 for x in include if x)
        bnames = [f.encode() for f in files]
        if n_inc > 1:
            print_phy(out, n_inc, D.array(), bnames, flag,
                      cfg["precision"], include, target)
            if nout is not None and N is not None:
                print_phy(nout, n_inc, N.array(), bnames, flag,
                          cfg["precision"], include, target)


def mat_union_matrix(files, target, include, cfg):
    """ltdMatrix_get (ltdmatrix.c:32-203): single-pass union-mode .mat
    matrix; -2 distances exclude the partner sample mid-run without
    rewinding already-written cells."""
    min_depth = cfg["min_depth"]
    min_length = cfg["min_length"]
    min_cov = cfg["min_cov"]
    D = QuantCells(cfg["dtype"], cfg["bytescale"],
                   mmap_dir=cfg.get("mmap_dir"))
    N = QuantCells(cfg["dtype"], cfg["bytescale"],
                   mmap_dir=cfg.get("mmap_dir"))
    stripped = {}
    raw = {}

    def load_raw(s):
        if s not in raw:
            raw[s] = kma.load_mat_template(files[s], target)
        return raw[s]

    def get_stripped(j):
        if j not in stripped:
            tm = load_raw(j)
            stripped[j] = tm.stripped() if tm is not None else None
        return stripped[j]

    num_file = len(include)

    # union mode on the torch device: one all-pairs metric table over
    # the loadable samples; the stateful -2 exclusion walk below stays
    # on the host (pair values do not depend on it, only which pairs
    # are emitted)
    table = None
    dev_spec = _mat_device_spec(cfg)
    if dev_spec is not None:
        order = [s for s in range(num_file)
                 if include[s] and get_stripped(s) is not None]
        table = _mat_table(dev_spec, stripped, order, min_depth)

    for i in range(1, num_file):
        if include[i]:
            tm = load_raw(i)
            if tm is None:
                print(f'Template ("{target.decode()}") was not found in '
                      f"sample:\t{files[i]}", file=sys.stderr)
                include[i] = 0
            elif (tm.n_nucs(min_depth) < min_length
                  or tm.n_nucs(min_depth) < min_cov * tm.length):
                print(f'Template ("{target.decode()}") did not exceed '
                      f"threshold for inclusion:\t{files[i]}",
                      file=sys.stderr)
                include[i] = 0
            else:
                stripped[i] = tm.stripped()
        if include[i]:
            mat1 = stripped[i]

            def one(j, mat1=mat1, i=i):
                mat2 = get_stripped(j)
                if mat2 is None:
                    return -2.0, 0
                if table is not None:
                    return _mat_pair_from_table(table, i, j, mat1, mat2,
                                                cfg)
                return cmp_mats(
                    mat1.counts, mat1.totals, mat2.counts,
                    mat2.totals, cfg["norm"], min_depth, min_length,
                    min_cov, cfg["veccmp"])

            js = [j for j in range(i) if include[j]]
            for j in js:
                get_stripped(j)  # sequential loads (shared parse cache)
            for j, (dist, rinc) in _pair_map(cfg.get("threads", 1),
                                             one, js):
                if dist < 0:
                    if dist == -1.0:
                        print("No sufficient overlap between samples:\t"
                              f"{files[i]}, {files[j]}", file=sys.stderr)
                    elif dist == -2.0:
                        print(f'Template ("{target.decode()}") did not '
                              "exceed threshold for inclusion:\t"
                              f"{files[j]}", file=sys.stderr)
                if dist >= -1.0:
                    D.add(dist)
                    N.add(rinc)
                else:
                    include[j] = 0
    return D, N, include


def msa_matrix(filenames, out, nout, cfg, diff) -> None:
    """ltdMsaMatrix_get (cdist.c:196-390): records of one fasta."""
    flag = cfg["flag"]
    pair = bool(flag & 2)
    trans = pack2bit.get_2bit_table(flag)
    motifs = []
    if cfg["methfilename"]:
        motifs = pack2bit.parse_meth_motifs(
            fileio.read_bytes(cfg["methfilename"]))
    data = fileio.read_bytes(filenames[0] if filenames else "-")
    length = 0
    min_length = cfg["min_length"]
    ref = None
    seqs = []
    includes = []
    headers = []
    shared_inc = None
    for header, raw in kma.iter_fasta(data):
        seq = pack2bit.translate(raw, trans)
        if ref is not None:
            if len(seq) != length:
                print(f"Sequences does not match: {header.decode()}",
                      file=sys.stderr)
                sys.exit(1)
            if pair:
                inc = pack2bit.init_inc_pos(length)
                packed, _ = pack2bit.pack_2bit(seq)
                pack2bit.mask_motifs(packed, inc, length, motifs)
                pack2bit.get_inc_pos(inc, seq, seq, cfg["proxi"],
                                     cfg["incvariant"])
                n_inc = snp.get_npos(inc)
                if n_inc < min_length:
                    print(f"# Excluded:\t{header.decode()}\t( {n_inc} / "
                          f"{length} )", file=sys.stderr)
                else:
                    print(f"# Included:\t{header.decode()}\t( {n_inc} / "
                          f"{length} )", file=sys.stderr)
                    seqs.append(packed)
                    includes.append(inc)
                    headers.append(header)
            else:
                packed, ns = pack2bit.pack_2bit(seq)
                n_inc = length - ns
                # MSA shared mode uses a STRICT threshold (cdist.c:270)
                if min_length < n_inc:
                    print(f"# Included:\t{header.decode()}\t( {n_inc} / "
                          f"{length} )", file=sys.stderr)
                    pack2bit.mask_motifs(packed, shared_inc, length,
                                         motifs)
                    pack2bit.get_inc_pos(shared_inc, seq, ref,
                                         cfg["proxi"], cfg["incvariant"])
                    seqs.append(packed)
                    headers.append(header)
                else:
                    print(f"# Excluded:\t{header.decode()}\t( {n_inc} / "
                          f"{length} )", file=sys.stderr)
        else:
            length = len(seq)
            if min_length < min_cov_len(cfg["min_cov"], length):
                min_length = min_cov_len(cfg["min_cov"], length)
            inc = pack2bit.init_inc_pos(length)
            packed, _ = pack2bit.pack_2bit(seq)
            pack2bit.mask_motifs(packed, inc, length, motifs)
            pack2bit.get_inc_pos(inc, seq, seq, cfg["proxi"],
                                 cfg["incvariant"])
            n_inc = snp.get_npos(inc)
            if n_inc < min_length:
                print(f"# Excluded:\t{header.decode()}\t( {n_inc} / "
                      f"{length} )", file=sys.stderr)
            else:
                print(f"# Included:\t{header.decode()}\t( {n_inc} / "
                      f"{length} )", file=sys.stderr)
                seqs.append(packed)
                includes.append(inc)
                headers.append(header)
                if not pair:
                    shared_inc = inc
                ref = seq

    n = len(seqs)
    D = QuantCells(cfg["dtype"], cfg["bytescale"],
                   mmap_dir=cfg.get("mmap_dir"))
    N = QuantCells(cfg["dtype"], cfg["bytescale"],
                   mmap_dir=cfg.get("mmap_dir"))
    norm = cfg["norm"]
    have_n = False
    if not n:
        print("All sequences were trimmed away.", file=sys.stderr)
        return
    if pair:
        have_n = True
        for i in range(n):
            for j in range(i):
                pinc = snp.mask_proxi(includes[i], includes[j], seqs[i],
                                      seqs[j], length, cfg["proxi"])
                if diff is not None:
                    _print_diffs(diff, i, j, seqs[i], seqs[j], pinc,
                                 length)
                dist, inc = snp.fsacmpair(seqs[i], seqs[j], pinc)
                if min_length <= inc:
                    D.add(dist * norm / inc if norm else float(dist))
                else:
                    D.add(-1.0, rnd=0.0)
                N.add(float(inc))
    else:
        inc_global = snp.get_npos(shared_inc)
        print(f"# {inc_global} / {length} bases included in distance "
              "matrix.", file=sys.stderr)
        nfactor = (norm / inc_global) if norm else 1.0
        for i in range(n):
            for j in range(i):
                if diff is not None:
                    _print_diffs(diff, i, j, seqs[i], seqs[j],
                                 shared_inc, length)
                D.add(nfactor * snp.fsacmp(seqs[i], seqs[j], shared_inc))
    if n > 1:
        print_phy(out, n, D.array(), headers, flag, cfg["precision"])
        # the reference prints the N matrix to the MAIN output here
        # (cdist.c:364-368), gated on -n
        if nout is not None and have_n and n > 1:
            print_phy(out, n, N.array(), headers, flag, cfg["precision"])


def add2matrix(path, addfilename, outputfilename, target, cfg) -> int:
    """add2Matrix (dist.c:331-411)."""
    data = fileio.read_bytes(outputfilename)
    n, pos = get_size_phy(data)
    # convert path to dir (dist.c:344-356)
    slash = path.rfind("/")
    prefix = path[:slash + 1] if slash >= 0 else path
    names, pos = get_filenames_phy(data, pos, n, prefix.encode(),
                                   cfg["sep"].encode())
    if pos < len(data) and data[pos:].strip():
        print("Cannot update a multi distance phylip file.",
              file=sys.stderr)
        return 1

    head = fileio.read_bytes(addfilename)[:1]
    tgt = target.encode() if target else b""
    if head == b">":
        D, N = fsa_row(addfilename, tgt, names, cfg)
    else:
        D, N = mat_row(addfilename, tgt, names, cfg)
    if D is None:
        print("Distance measures failed and thus the matrix was not "
              "updated.", file=sys.stderr)
        return 1
    print_phy_update(outputfilename, n + 1, addfilename.encode(), D,
                     cfg["flag"], cfg["precision"])
    if cfg["noutputfilename"]:
        print_phy_update(cfg["noutputfilename"], n + 1,
                         addfilename.encode(), N, cfg["flag"],
                         cfg["precision"])
    return 0


def fsa_row(addfilename, target, names, cfg):
    """ltdFsaRowThrd (fsacmpthrd.c:482-667)."""
    trans = pack2bit.get_2bit_table(cfg["flag"])
    data = fileio.read_bytes(addfilename)
    seq = kma.load_fasta_seq(data, target, trans)
    if seq is None:
        print(f'Missing template entry ("{target.decode()}") in file:\t'
              f"{addfilename}", file=sys.stderr)
        sys.exit(1)
    length = len(seq)
    min_length = max(cfg["min_length"], min_cov_len(cfg["min_cov"],
                                                    length))
    inc_add = pack2bit.init_inc_pos(length)
    pack2bit.get_inc_pos(inc_add, seq, seq, cfg["proxi"],
                         cfg["incvariant"])
    if snp.get_npos(inc_add) < min_length:
        print(f'Template ("{target.decode()}") did not exceed threshold '
              f"for inclusion:\t{addfilename}", file=sys.stderr)
        return None, None
    packed, _ = pack2bit.pack_2bit(seq)
    D = []
    N = []
    norm = cfg["norm"]
    for nm in names:
        fn = nm.decode()
        sdata = fileio.read_bytes(fn)
        sseq = kma.load_fasta_seq(sdata, target, trans)
        inc = inc_add.copy()
        pack2bit.get_inc_pos(inc, sseq, seq, cfg["proxi"],
                             cfg["incvariant"])
        spacked, _ = pack2bit.pack_2bit(sseq)
        dist, n_shared = snp.fsacmpair(packed, spacked, inc)
        if min_length <= n_shared:
            D.append(dist * norm / n_shared if norm else float(dist))
        else:
            D.append(-1.0)
            n_shared = 0
            print(f"No sufficient overlap with sample:\t{fn}",
                  file=sys.stderr)
        N.append(float(n_shared))
    return D, N


def mat_row(addfilename, target, names, cfg):
    """ltdRowThrd (ltdmatrixthrd.c:564-611)."""
    min_depth = cfg["min_depth"]
    min_length = cfg["min_length"]
    min_cov = cfg["min_cov"]
    tm = kma.load_mat_template(addfilename, target)
    if (tm is None or tm.n_nucs(min_depth) < min_length
            or tm.n_nucs(min_depth) < min_cov * tm.length):
        print(f'Template ("{target.decode()}") did not exceed threshold '
              f"for inclusion:\t{addfilename}", file=sys.stderr)
        return None, None
    mat1 = tm.stripped()
    D = []
    N = []
    for nm in names:
        fn = nm.decode()
        tm2 = kma.load_mat_template(fn, target)
        if tm2 is None:
            print(f'Template ("{target.decode()}") did not exceed '
                  f"threshold for inclusion:\t{fn}", file=sys.stderr)
            sys.exit(1)
        mat2 = tm2.stripped()
        dist, rinc = cmp_mats(mat1.counts, mat1.totals, mat2.counts,
                              mat2.totals, cfg["norm"], min_depth,
                              min_length, min_cov, cfg["veccmp"])
        if dist == -2.0:
            print(f'Template ("{target.decode()}") did not exceed '
                  f"threshold for inclusion:\t{fn}", file=sys.stderr)
            sys.exit(1)
        if dist == -1.0:
            print(f"No sufficient overlap with sample:\t{fn}",
                  file=sys.stderr)
        D.append(dist)
        N.append(float(rinc))
    return D, N
