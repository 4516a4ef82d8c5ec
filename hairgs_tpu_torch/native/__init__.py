"""Native (C++) host accelerators of the strand topology, loaded with ctypes
(counterpart of hairgs_tpu/native/__init__.py).

`strand_walk.cc` walks the endpoint-pair graph into strands and
`merge_candidates.cc` enumerates and filters merge candidates. Both are
compiled by `g++ -O3 -shared -fPIC -ffp-contract=off` into
`_build/libhairgs_native.so` on first use (or when a source is newer than
the library), the same way `kernels.py` builds the CUDA kernels; nothing is
built when this module is imported. The library is used on every path: a
failed build raises. The numpy versions in `topo/strands.py` and
`topo/merge.py` are the oracles, run only when a caller asks for them.
"""

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
SOURCES = ("strand_walk.cc", "merge_candidates.cc")
LIB_PATH = BUILD_DIR / "libhairgs_native.so"
# no fused multiply-add: the candidate distances then round exactly as
# numpy's float32 norm does, so the stable sort by distance orders
# near-ties as the numpy oracle does
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_LIB = None

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PF = ctypes.POINTER(ctypes.c_float)
_PU8 = ctypes.POINTER(ctypes.c_uint8)


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((NATIVE_DIR / s).stat().st_mtime > built for s in SOURCES)


def build() -> Path:
    """Compile the library (to a temporary name, then renamed, so that
    concurrent builders never load a half-written file)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native strand-topology library "
                           "is built on first use and needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libhairgs_native.{os.getpid()}.tmp.so"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for the native library:\n{out.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        if _stale():
            build()
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.walk_strands.restype = ctypes.c_int64
        lib.walk_strands.argtypes = [_P64, ctypes.c_int64, ctypes.c_int64,
                                     _P64, _P64, _P64, _P32, _P32]
        lib.merge_candidates.restype = ctypes.c_int64
        lib.merge_candidates.argtypes = [
            _PF, _PF, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, _P64, _P64, _P64, _P64, _PF, ctypes.c_int64]
        lib.greedy_complementary_filter.restype = None
        lib.greedy_complementary_filter.argtypes = [
            _P64, ctypes.c_int64, _P64, ctypes.c_int64, _PU8]
        _LIB = lib
    return _LIB


def _ptr(a, kind):
    return a.ctypes.data_as(kind)


def merge_candidates(points, dirs, dist_th, dir_th, bidirectional,
                     tips_global, comp_global):
    """Grid-hash candidate search; returns (p1, p2, dist) arrays in the
    enumeration order of the reference's cKDTree ball query."""
    lib = _lib()
    points = np.ascontiguousarray(points, dtype=np.float32)
    dirs = np.ascontiguousarray(dirs, dtype=np.float32)
    tips = np.ascontiguousarray(tips_global, dtype=np.int64)
    comp = np.ascontiguousarray(comp_global, dtype=np.int64)
    m = points.shape[0]
    cap = max(1024, m * 16)
    while True:
        p1 = np.empty(cap, np.int64)
        p2 = np.empty(cap, np.int64)
        dist = np.empty(cap, np.float32)
        n = lib.merge_candidates(
            _ptr(points, _PF), _ptr(dirs, _PF), m, float(dist_th),
            float(dir_th), int(bool(bidirectional)), _ptr(tips, _P64),
            _ptr(comp, _P64), _ptr(p1, _P64), _ptr(p2, _P64),
            _ptr(dist, _PF), cap)
        if n >= 0:
            return p1[:n], p2[:n], dist[:n]
        cap *= 4


def greedy_complementary_filter(pairs, comp_map):
    """Keep-mask of the sequential greedy conflict filter."""
    lib = _lib()
    pairs = np.ascontiguousarray(pairs, dtype=np.int64)
    comp = np.ascontiguousarray(comp_map, dtype=np.int64)
    mask = np.empty(pairs.shape[0], np.uint8)
    lib.greedy_complementary_filter(_ptr(pairs, _P64), pairs.shape[0],
                                    _ptr(comp, _P64), comp.shape[0],
                                    _ptr(mask, _PU8))
    return mask.astype(bool)


def walk_strands(endpoint_pairs: np.ndarray, num_endpoints: int):
    """The strand walk of topo.strands._walk_strands_np in flat form:
    (seq (N, 2), rows (N,), offsets (num_strands + 1,), id_to_strand,
    complementary), strand s being rows offsets[s]:offsets[s + 1] of seq
    and rows."""
    lib = _lib()
    pairs = np.ascontiguousarray(endpoint_pairs, dtype=np.int64)
    ns = pairs.shape[0]
    seq = np.empty((ns, 2), dtype=np.int64)
    rows = np.empty(ns, dtype=np.int64)
    offsets = np.empty(ns + 1, dtype=np.int64)
    id_to_strand = np.full(num_endpoints, -1, dtype=np.int32)
    complementary = np.full(num_endpoints, -1, dtype=np.int32)
    num_strands = lib.walk_strands(
        _ptr(pairs, _P64), ns, num_endpoints, _ptr(seq, _P64),
        _ptr(rows, _P64), _ptr(offsets, _P64), _ptr(id_to_strand, _P32),
        _ptr(complementary, _P32))
    if num_strands < 0:
        raise RuntimeError("walk_strands failed (malformed graph?)")
    # segments of cycles are never walked: they lie past the last offset
    end = offsets[num_strands]
    return seq[:end], rows[:end], offsets[:num_strands + 1], id_to_strand, complementary
