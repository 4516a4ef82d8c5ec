"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exposes a plain C entry point. It is compiled by
`nvcc` for sm_90a into `_build/lib<name>.so` on first use (or when the
source is newer than the library) and loaded with ctypes. Nothing is built
when this module is imported, so a machine without `nvcc` or a card (where
the tests run the plain PyTorch versions) imports it freely.
"""

import contextlib
import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("composite_fwd", "composite_bwd", "precision_probe")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no fused multiply-add contraction: the kernels then round each
    # product exactly as the plain PyTorch version does, so the alpha gate
    # and the transmittance latch decide identically in both. A contracted
    # build is a few percent faster and flips some of those decisions, each
    # worth up to alpha * T * feature in the image (chip_smoke.py phase 6
    # builds and times it beside this one)
    "--fmad=false",
]

_LIBS = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return path


def _lib_path(name: str, suffix: str = "") -> Path:
    return BUILD_DIR / f"lib{name}{suffix}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared header."""
    lib = _lib_path(name)
    srcs = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    return not lib.exists() or lib.stat().st_mtime < max(s.stat().st_mtime for s in srcs)


def build(names=KERNELS, verbose: bool = False, variants=None,
          src_dir: Path = CSRC_DIR) -> dict:
    """Compile the named kernels, all nvcc processes started together;
    returns the wall seconds of each build, and the compiler's report when
    verbose (-Xptxas -v: registers, shared memory, spills). `variants`
    maps a library suffix to the flags that replace NVCC_FLAGS for it
    (default: the one library per kernel that the wrappers load); report
    keys are name + suffix. `src_dir` holds the sources (default csrc/)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for suffix, flags in (variants or {"": NVCC_FLAGS}).items():
        for name in names:
            tmp = BUILD_DIR / f"lib{name}{suffix}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *flags, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", str(tmp), str(src_dir / f"{name}.cu")]
            procs[name + suffix] = (tmp, _lib_path(name, suffix), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report = {}
    for key, (tmp, lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        os.replace(tmp, lib)
        report[key] = {"seconds": time.perf_counter() - t0,
                       **({"ptxas": out} if verbose else {})}
    return report


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


@contextlib.contextmanager
def variant(suffix: str):
    """Inside the block the wrappers launch the kernels of the libraries
    lib<name><suffix>.so, built before by build(variants={suffix: ...})."""
    saved = dict(_LIBS)
    for name in KERNELS:
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name, suffix)))
    try:
        yield
    finally:
        _LIBS.clear()
        _LIBS.update(saved)
