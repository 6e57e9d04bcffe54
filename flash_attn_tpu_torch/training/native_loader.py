"""ctypes binding of the native C++ token loader (counterpart of
`flash_attn_tpu/training/native_loader.py`).

`standalone/src/data_loader.cpp` memory-maps .bin token shards and fills
(batch, seq_len + 1) int32 batches on background threads in a shuffled
order that is a function of (seed, epoch), resumable at (epoch, batch
index).  The port builds that source itself, with `g++ -O2 -shared -fPIC`,
into `flash_attn_tpu_torch/_build/` at first use (again when the source is
newer), and raises if the build fails.  Batches come back as produced, so
near, not exactly, in index order: each is returned with its index.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "standalone" / "src" / "data_loader.cpp"
LIBRARY = PKG_DIR / "_build" / "libfa_data_loader.so"

_lib_handle = None


def build(force: bool = False) -> Path:
    """Compile the loader into `_build/` unless it is newer than its
    source.  Raises RuntimeError if g++ fails."""
    if (not force and LIBRARY.exists()
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime):
        return LIBRARY
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.tmp{os.getpid()}")
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(SOURCE),
           "-o", str(tmp), "-lpthread"]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"(g++ exit {out.returncode}):\n{out.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(build()))
        lib.nl_create.restype = ctypes.c_void_p
        lib.nl_create.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
        lib.nl_add_shard.restype = ctypes.c_int
        lib.nl_add_shard.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.nl_start.restype = ctypes.c_int
        lib.nl_start.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int]
        lib.nl_num_batches.restype = ctypes.c_int64
        lib.nl_num_batches.argtypes = [ctypes.c_void_p]
        lib.nl_next.restype = ctypes.c_int64
        lib.nl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.nl_destroy.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
    return _lib_handle


class NativeLMLoader:
    """Iterate (batch index, (batch, seq_len + 1) int32 batch) over .bin
    token shards, from `start_batch` of `epoch` to the epoch's end."""

    def __init__(self, shard_paths, seq_len, batch_size, *, seed=0,
                 token_dtype=np.uint16, epoch=0, start_batch=0, nthreads=2):
        self._lib = _lib()
        itemsize = np.dtype(token_dtype).itemsize
        self._h = self._lib.nl_create(seq_len, batch_size, seed, itemsize, 0)
        for p in shard_paths:
            rc = self._lib.nl_add_shard(self._h, str(p).encode())
            if rc != 0:
                self.close()
                raise OSError(f"cannot map shard {p} (rc={rc})")
        if self._lib.nl_start(self._h, epoch, start_batch, nthreads) != 0:
            self.close()
            raise ValueError("dataset smaller than one batch")
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.num_batches = self._lib.nl_num_batches(self._h)

    def __iter__(self):
        return self

    def __next__(self):
        out = np.empty((self.batch_size, self.seq_len + 1), np.int32)
        idx = self._lib.nl_next(self._h, out.ctypes.data)
        if idx < 0:
            raise StopIteration
        return idx, out

    def close(self):
        if self._h:
            self._lib.nl_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
