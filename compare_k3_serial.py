#!/usr/bin/env python3
"""K3's cyclic route against the serial cyclic kernel it replaced, on one
NVIDIA GPU.

    python3 compare_k3_serial.py DIR

DIR is a checkout whose graphaligner_tpu_torch/csrc/exhaustive.cu still
holds ``ga_exhaustive_serial`` (one thread a lane over whole passes, every
table in device memory): the commit before the cyclic route's redesign,
unpacked with ``git archive``. Runs the cyclic -i and circular -i corpora
through ``align_reads`` as chip_smoke.py does, recording each K3 call.
Then, on each call's arguments, builds DIR's kernel with this checkout's
nvcc flags, holds its six slabs and flags equal to the cyclic route's, and
times the two in turns (serial, route, route, serial), each timing
warmed up by one call first. Prints the card's name and power limit and
one line a corpus; exits non-zero on any failure.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import chip_smoke as smoke


def serial_kernel(root):
    """DIR's ga_exhaustive_serial, built into build/kernels/; returns a
    function of a K3 call's arguments that launches it and returns its six
    slabs and flags."""
    import torch

    from graphaligner_tpu_torch.ops import _build

    csrc = os.path.join(os.path.abspath(root), "graphaligner_tpu_torch",
                        "csrc")
    so = os.path.join(smoke.ROOT, "build", "kernels", "serial_exhaustive.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so,
         os.path.join(csrc, "exhaustive.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        smoke.fail(f"{csrc}/exhaustive.cu did not build:\n{proc.stderr}")
    fn = ctypes.CDLL(so).ga_exhaustive_serial
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]

    def run(args, kw):
        S, _, _, B = args[0].shape
        P, K = args[4].shape
        N = kw["num_nodes"]
        out = torch.empty((6, S, P, B), dtype=torch.int32, device="cuda")
        store = torch.empty((N, 6, B), dtype=torch.int32, device="cuda")
        nonconv = torch.empty((B,), dtype=torch.int32, device="cuda")
        err = fn(*[a.data_ptr() for a in (*args, out, store, nonconv)],
                 S, P, K, N, B, kw.get("max_passes", 128),
                 _build.stream_handle(args[0].device))
        _build.check(err, "serial exhaustive")
        return (*out.unbind(0), nonconv != 0)

    return run


def main() -> int:
    if len(sys.argv) != 2:
        smoke.fail("usage: compare_k3_serial.py DIR")
    sys.path.insert(0, smoke.ROOT)
    os.environ["GA_NO_FALLBACK"] = "1"
    import torch

    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)

    from graphaligner_tpu_torch.ops import exhaustive as k3

    serial = serial_kernel(sys.argv[1])
    rec = smoke.K3Recorder()
    fix = smoke.FIX
    corpora = [
        ("cyclic -i", f"{fix}/sim/cyclic.gfa",
         f"{fix}/torch/cyclic_i/reads.fastq"),
        ("circular -i", f"{fix}/torch/circular_i/graph.gfa",
         f"{fix}/torch/circular_i/reads.fastq"),
    ]
    build = os.path.join(smoke.ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        try:
            for name, graph_file, reads_file in corpora:
                rec.corpus = name
                smoke.run_exhaustive(graph_file, reads_file, tmp)
        finally:
            rec.close()
    for name, _, _ in corpora:
        calls = [c for c in rec.calls if c[0] == name]
        if len(calls) != 1 or not calls[0][2]["cyclic"]:
            smoke.fail(f"expected one K3 call on {name}, on the cyclic route")
        _, a, k, _ = calls[0]
        reps = 5 if a[1].shape[0] < 10_000 else 1
        smoke.k3_equal(k3.exhaustive(*a, **k), serial(a, k),
                       f"between the cyclic route and the serial kernel on "
                       f"{name}")
        old = smoke.cuda_ms(lambda: serial(a, k), reps)
        new = smoke.cuda_ms(lambda: k3.exhaustive(*a, **k), reps)
        new2 = smoke.cuda_ms(lambda: k3.exhaustive(*a, **k), reps)
        old2 = smoke.cuda_ms(lambda: serial(a, k), reps)
        S, _, _, B = a[0].shape
        print(f"{name} at S={S} P={a[1].shape[0]} B={B}: outputs equal; in "
              f"turns (mean of {reps} each, warmed up) serial {old:.4f} ms, "
              f"route {new:.4f} ms, route {new2:.4f} ms, serial {old2:.4f} ms;"
              f" speed-up {(old + old2) / (new + new2):.3f}x [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
