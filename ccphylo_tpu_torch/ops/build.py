"""Build and bind the port's hand-written CUDA kernels.

Each source ``csrc/<stem>.cu`` is compiled by nvcc for ``sm_90a`` into
a shared library with a plain C interface, named by a hash of its
content, the shared headers (``csrc/*.cuh``) and the flags, in
``ccphylo_tpu_torch/_build/`` (git-ignored), and loaded with ctypes.
Builds run at first use, every missing source at once with one nvcc
process each, so a fresh checkout builds everything on its first kernel
call.

There is no fallback: a failed build, a refused launch or a non-zero
``cudaGetLastError()`` raises.  Every C entry point launches on the
stream it is given, allocates nothing, and returns
``cudaGetLastError()``; `launch` raises on a non-zero code and only
then counts the launch in `launches`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# source stem -> {C entry point: argtypes}; every entry point ends with
# the stream argument and returns an int (cudaError_t)
ENTRY_POINTS = {
    "snp_expand": {
        # seqs, ld_seq, swap, pair_mask, X, n, W, stream
        "snp_expand_shared": [_P, _I, _I, _P, _P, _I, _I, _P],
        # seqs, ld_seq, swap, masks, ld_mask, inc_words, X, M, n, W, stream
        "snp_expand_pairwise": [_P, _I, _I, _P, _I, _I, _P, _P, _I, _I,
                                _P],
    },
    "qrow_mins": {
        # rows, K, co, words, n, sd2, slotof (or null), rmin, rarg, stream
        "qrow_mins": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _P],
    },
    "dnj_segment": {
        # words, n, sd2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2, stats, t0,
        # t1, m, G, scratch, flags, stream
        "dnj_segment": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _P, _I, _P],
    },
    "dnj_segment_float": {
        # D, n, sD, N, Q, P, seed, I, J, LI, LJ, exact (or null),
        # first_inexact, stats, t0, t1, m, neg_limbs, G, scratch, flags,
        # stream
        "dnj_segment_float": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P],
    },
}
# source stem -> {C function that launches nothing: argtypes}; each
# returns an int of its own meaning (see `query`)
QUERIES = {
    # flags, n
    "dnj_segment": {"dnj_segment_max_blocks": [_I, _I]},
    # flags, n, G; flags, n, G; G, n, flags
    "dnj_segment_float": {"dnj_segment_float_max_blocks": [_I, _I, _I],
                          "dnj_segment_float_fits": [_I, _I, _I],
                          "dnj_segment_float_scratch_bytes": [_I, _I, _I]},
}

# launches of each kernel since the last reset_launches(); qrow_mins on
# a row cache (its slot argument given) is counted under its own name
launches = {fn: 0 for eps in ENTRY_POINTS.values() for fn in eps}
launches["qrow_mins_slots"] = 0

_libs: dict[str, ctypes.CDLL] = {}
# a variant's key -> (its source stem, its -D flags); see `variant`
_variants: dict[str, tuple[str, list[str]]] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def variant(stem: str, **defines) -> str:
    """A build of csrc/<stem>.cu with the macros `defines` (nvcc's -D
    NAME=value) beside its default build, to time a kernel's
    compile-time constants in turns; returns the key that `launch` and
    `query` take in place of the stem.  `build_all` builds it with the
    rest at its first use."""
    flags = [f"-D{k}={v}" for k, v in sorted(defines.items())]
    key = " ".join([stem, *flags])
    _variants[key] = (stem, flags)
    return key


def _source(key: str) -> tuple[str, list[str]]:
    return _variants.get(key, (key, []))


def _lib_path(key: str) -> str:
    stem, defines = _source(key)
    h = hashlib.sha256()
    for path in [os.path.join(CSRC, stem + ".cu"),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def build_all() -> float:
    """Compile every kernel library (and `variant`) that is not built
    yet, in parallel.  Returns the wall seconds spent; raises with nvcc's
    output on failure."""
    t0 = time.perf_counter()
    todo = [k for k in [*ENTRY_POINTS, *_variants]
            if not os.path.exists(_lib_path(k))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for key in todo:
        stem, defines = _source(key)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", tmp,
               os.path.join(CSRC, stem + ".cu")]
        procs.append((key, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for key, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode == 0:
            os.replace(tmp, _lib_path(key))  # atomic: parallel-safe
        else:
            os.unlink(tmp)
            stem, defines = _source(key)
            errors.append(f"{' '.join([stem + '.cu', *defines])}:\n"
                          f"{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def _lib(key: str) -> ctypes.CDLL:
    lib = _libs.get(key)
    if lib is None:
        build_all()
        stem = _source(key)[0]
        lib = ctypes.CDLL(_lib_path(key))
        for fn, argtypes in {**ENTRY_POINTS[stem],
                             **QUERIES.get(stem, {})}.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[key] = lib
    return lib


def launch(stem: str, fn: str, *args, device: torch.device,
           count: str | None = None) -> None:
    """Call C entry point `fn` of csrc/<stem>.cu (or of the `variant`
    `stem`) on the current stream of `device`; raise if the launch
    reports an error.  The launch is counted under `count` (default:
    `fn`)."""
    lib = _lib(stem)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
    launches[count or fn] += 1


def query(stem: str, fn: str, *args) -> int:
    """Call the non-launching C function `fn` of csrc/<stem>.cu (one of
    QUERIES) and return its int."""
    return getattr(_lib(stem), fn)(*args)
