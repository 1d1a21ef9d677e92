"""ctypes binding of the reference's native slice DP (``slice.cpp``).

The library is built at first use with g++ from ``slice.cpp`` beside this
file into ``cuda_bench/.build/`` in the checkout, named by a hash of the
source and the flags, so a built library is loaded as it is. Concurrent
processes take a file lock around the build and rename a finished build
into place. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "slice.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / ".build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcb_slice-{h.hexdigest()[:16]}.so"


def get_lib():
    """The loaded library, built first if it is not there yet."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                       str(tmp), str(SOURCE)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"building the reference slice failed: "
                        f"{' '.join(cmd)}\n{proc.stderr}")
                os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    i64, i32, u8 = (ctypes.POINTER(t) for t in
                    (ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8))
    lib.cb_compute_slice.restype = ctypes.c_int64
    lib.cb_compute_slice.argtypes = [
        ctypes.c_int64, u8, i64, i32, ctypes.c_int64, i32, i32,
        ctypes.c_int64, i32, i64, ctypes.c_int64, i32, u8, i64, i64, u8,
        ctypes.c_int64, i64, u8, i64,
    ]
    _lib = lib
    return lib


def compute_slice_rows(chain, edge_ptr, edge_to, sp_cell, sp_pred, ps_cell,
                       ps_old, fs_cell, match, seed_sbs, old_end, old_flags,
                       slice_index):
    """Banded slice DP over C cells. Returns (sbs, sbs_exists, rows[64, C]),
    or None for an empty band."""
    lib = get_lib()
    C = len(seed_sbs)
    a = {
        "chain": np.ascontiguousarray(chain, dtype=np.uint8),
        "edge_ptr": np.ascontiguousarray(edge_ptr, dtype=np.int64),
        "edge_to": np.ascontiguousarray(edge_to, dtype=np.int32),
        "sp_cell": np.ascontiguousarray(sp_cell, dtype=np.int32),
        "sp_pred": np.ascontiguousarray(sp_pred, dtype=np.int32),
        "ps_cell": np.ascontiguousarray(ps_cell, dtype=np.int32),
        "ps_old": np.ascontiguousarray(ps_old, dtype=np.int64),
        "fs_cell": np.ascontiguousarray(fs_cell, dtype=np.int32),
        "match": np.ascontiguousarray(match, dtype=np.uint8),
        "seed_sbs": np.ascontiguousarray(seed_sbs, dtype=np.int64),
        "old_end": np.ascontiguousarray(old_end, dtype=np.int64),
        "old_flags": np.ascontiguousarray(old_flags, dtype=np.uint8),
    }
    sbs = np.empty(C, dtype=np.int64)
    sbs_exists = np.empty(C, dtype=np.uint8)
    rows = np.empty((64, C), dtype=np.int64)

    def p(x):
        return x.ctypes.data_as(ctypes.POINTER(
            np.ctypeslib.as_ctypes_type(x.dtype)))

    ok = lib.cb_compute_slice(
        C, p(a["chain"]), p(a["edge_ptr"]), p(a["edge_to"]),
        len(a["sp_cell"]), p(a["sp_cell"]), p(a["sp_pred"]),
        len(a["ps_cell"]), p(a["ps_cell"]), p(a["ps_old"]),
        len(a["fs_cell"]), p(a["fs_cell"]), p(a["match"]), p(a["seed_sbs"]),
        p(a["old_end"]), p(a["old_flags"]), int(slice_index), p(sbs),
        p(sbs_exists), p(rows),
    )
    if not ok:
        return None
    return sbs, sbs_exists.astype(bool), rows
