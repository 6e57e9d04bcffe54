"""Build and load the hand-written CUDA kernels (no JAX counterpart: Pallas
kernels compile at trace time).

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own by
`nvcc` for Hopper (`sm_90a`) into `_build/lib<name>.so`, which is loaded with
`ctypes`; a library of `DERIVED` is another one's source compiled with
extra flags.  The build happens at first use, is reused while the library is
newer than its source and the shared `csrc/*.cuh` headers, and raises on any
failure: nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("flash_fwd", "flash_decode_ref", "flash_decode_ref_wide",
           "flash_bwd", "flash_bwd_wide", "flex", "diag_dma_stream",
           "diag_int8_decode", "diag_varlen_bisect")
# name -> (source, extra nvcc flags): the decode and backward kernels' head
# dims 192 and 256 in translation units of their own, which build beside
# the ones of 64 and 128 (the decode's four in one file took ~150 s of
# `nvcc`, the longest build)
DERIVED = {"flash_decode_ref_wide": ("flash_decode_ref",
                                     ("-DFA_DECODE_WIDE",)),
           "flash_bwd_wide": ("flash_bwd", ("-DFA_BWD_WIDE",))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _source(name: str) -> tuple[str, tuple]:
    return DERIVED.get(name, (name, ()))


def sources(name: str) -> list[Path]:
    """What kernel `name` is built from: `csrc/<source>.cu` and the shared
    `csrc/*.cuh` headers (not every `csrc/<name>*`, which would take
    `csrc/<name>_other.cu` as a source too)."""
    return [CSRC_DIR / f"{_source(name)[0]}.cu", *CSRC_DIR.glob("*.cuh")]


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    src_mtime = max(p.stat().st_mtime for p in sources(name))
    return lib.stat().st_mtime < src_mtime


def build(names=KERNELS) -> dict[str, dict]:
    """Compile the stale kernels among `names`, one `nvcc` process each, all
    started together.  Returns {name: {"seconds", "ptxas"}} for the ones
    built; raises RuntimeError if any build fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        src, flags = _source(name)
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(CSRC_DIR / f"{src}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, _lib_path(name))
        build_info[name] = {
            "seconds": round(secs, 2),
            "ptxas": [ln.strip() for ln in out.splitlines()
                      if "ptxas" in ln or "spill" in ln],
        }
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: build_info[n] for n in todo}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def declare_error_string(lib: ctypes.CDLL) -> None:
    """Every kernel library exports `fa_error_string(int) -> const char*`."""
    lib.fa_error_string.argtypes = [ctypes.c_int]
    lib.fa_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code (its
    `cudaGetLastError()` right after the launch)."""
    if err != 0:
        msg = lib.fa_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
