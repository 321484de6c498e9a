"""Native (C++) host-runtime kernels with transparent build + fallback
(counterpart of ccphylo_tpu/native).

The device compute path is PyTorch/CUDA; this package accelerates the
host runtime around it — the same loops the reference keeps in C
(phy.c loadPhy/printphy, matparse.c, qseqs.c qseq2nibble).  The shared
library is compiled at first use (g++ -O3, keyed on a source hash) into
the package's git-ignored ``_build/`` directory; every consumer falls
back to the pure Python/numpy implementation when the toolchain or
library is unavailable, so behavior is identical either way
(fuzz-tested).

Set CCPHYLO_TORCH_NO_NATIVE=1 to force the Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "ccphylo_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lib = None
_tried = False


def _build() -> str | None:
    try:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    except OSError:
        return None
    out = os.path.join(_BUILD_DIR, f"_ccphylo_native_{digest}.so")
    if os.path.exists(out):
        return out
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
    except OSError:
        return None
    for cxx in ("g++", "c++", "clang++"):
        tmp = None
        try:
            # build to a temp name, atomic rename (parallel-safe)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            subprocess.run(
                [cxx, "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=180)
            os.replace(tmp, out)
            return out
        except (OSError, subprocess.SubprocessError):
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            continue
    return None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("CCPHYLO_TORCH_NO_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64 = ctypes.c_int64
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    p_u16 = ctypes.POINTER(ctypes.c_uint16)
    p_u64 = ctypes.POINTER(ctypes.c_uint64)

    lib.phy_body.restype = i64
    lib.phy_body.argtypes = [p_u8, i64, p_i64, i64, ctypes.c_uint8,
                             p_f64, p_i64, p_i64]
    lib.fmt_cells.restype = i64
    lib.fmt_cells.argtypes = [p_f64, i64, ctypes.c_int32, p_u8, i64]
    lib.mat_rows.restype = i64
    lib.mat_rows.argtypes = [p_u8, i64, p_i64, p_u8, p_u16, p_i64, i64]
    lib.mat_count_rows.restype = i64
    lib.mat_count_rows.argtypes = [p_u8, i64, i64]
    lib.fasta_pack.restype = i64
    lib.fasta_pack.argtypes = [p_u8, i64, p_u8, p_u64, p_i64]
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    lib.init_hnj_u8.restype = i64
    lib.init_hnj_u8.argtypes = [p_u8, i64, i64, p_i32, p_i32, p_i32]
    lib.replay_join_u8.restype = i64
    lib.replay_join_u8.argtypes = [p_u8, i64, i64, i64, i64, p_i32, p_i32,
                                   p_i32, p_i32, p_i32]
    if lib.ccphylo_native_abi() != 1:
        return None
    _lib = lib
    return _lib


def get_lib():
    """The loaded ctypes library, or None when unavailable."""
    return _load()


def available() -> bool:
    return _load() is not None
