"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled at first use, on the machine with the
card, by ``nvcc`` into a shared library with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). The library
lands in ``build/kernels/`` at the repository root, named by a hash of its
sources, the shared headers and the flags, so an edited source rebuilds and
an unchanged one is loaded as it is.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / spills per kernel, kept in BUILD_LOG
]

_LIBS: dict = {}
# name -> (seconds of the build this process ran, or 0.0 for a library
# built before, whose compiler stderr is kept beside it; compiler stderr)
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                f"{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stderr)
        os.replace(tmp, out)
        BUILD_LOG[name] = (time.time() - t0, proc.stderr)
    elif name not in BUILD_LOG:
        log = out.with_suffix(".log")
        BUILD_LOG[name] = (0.0, log.read_text() if log.exists() else "")
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
