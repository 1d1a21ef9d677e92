#!/usr/bin/env python3
"""K1's wide route and the projection kernel on recorded calls, against
another checkout's kernels in turns, on one NVIDIA GPU.

    python3 compare_k1_proj.py [DIR] [--lanes 2,4,8]

Runs, under GA_NO_FALLBACK=1 through align_reads_seeded_batch as
chip_smoke.py drives them, converging -b 35 (in-degree 80, its reads that
the JAX package aligned on its device tiled past 1,000; no reach table, so
every band goes through the projection at K_out 80), multiallelic x10 -b
35 (in-degree 8) and longsim x10 -b 35, then longsim x10 -b 35 under
GA_REACH_MAXN=0, and records: converging's K1 call with the most lanes at
each capacity tier (Cm 288, 576, 1152), multiallelic's and longsim's
(the narrow route's) widest K1 calls, and the heaviest projection call
(the most previous-band slots) of converging and of longsim without a
reach table. Each call is held bit for bit against its plain version
(slice_cells_plain, project_band_plain) and timed: K1 between CUDA events,
the projection (a memset and two launches, whose host issue sets the
events' interval back to back) as torch.profiler's device time.

DIR is another checkout (``git archive <rev> graphaligner_tpu_torch | tar
-x -C DIR``, in a directory that .gitignore lists): its ops/ is imported
under another name, so its wrappers build DIR's csrc/ into DIR's own
build/kernels/. Each call is then also run through DIR's kernels, held
equal to this checkout's outputs, and the two are timed in turns (DIR,
this, this, DIR). Where a library exports ``ga_split_read`` (a copy
instrumented with clock64 stamps), the per-phase clock split of a launch
is printed too: K1's blocks' phases A, A2, B and C (mean and slowest
block), the slowest slot thread's in-neighbour classification and lane
0's node-start cells; the projection's expansion, dedup and placement
summed over a lane's trips (mean and slowest lane).

--lanes times each wide K1 call of this checkout at other lanes a block
(``banded_cell.WIDE_LANES``). Prints the card's name and power limit and
one line a call; exits non-zero on any failure.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import os
import subprocess
import sys

import chip_smoke as smoke

REPS = 20


def load_ops(root, name):
    """(banded_cell, project_band) of ROOT's graphaligner_tpu_torch/ops,
    imported as package ``name``."""
    ops = os.path.join(os.path.abspath(root), "graphaligner_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ops, "__init__.py"),
        submodule_search_locations=[ops])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return (importlib.import_module(f"{name}.banded_cell"),
            importlib.import_module(f"{name}.project_band"))


def split_reader(k1mod, lib_name):
    """A function that resets the library's clock split, runs a launch
    and returns the split as a list of int rows of 8, or None when the
    library exports no split."""
    lib = k1mod._build.library(lib_name)
    if not hasattr(lib, "ga_split_read"):
        return None
    lib.ga_split_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ga_split_read.restype = ctypes.c_int

    def run(fn, n):
        import torch

        torch.cuda.synchronize()
        lib.ga_split_reset()
        fn()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (8 * n))()
        if lib.ga_split_read(buf, 8 * n) != 0:
            smoke.fail("ga_split_read failed")
        return [list(buf[8 * i:8 * i + 8]) for i in range(n)]

    return run


def mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def k1_split(rows, clock):
    """K1's per-block stamps: 0 start, 1-3 after phases A, A2, B, 4 after
    C; 5 the block's slowest classification, 6 lane 0's node-start cycles,
    7 its node-start cells."""
    us = [[(r[i + 1] - r[i]) / clock for i in range(4)] for r in rows]
    mean = [sum(u[i] for u in us) / len(us) for i in range(4)]
    slow = max(range(len(us)), key=lambda i: sum(us[i]))
    r = rows[slow]
    return (f"phases A/A2/B/C mean {' / '.join(f'{x:.2f}' for x in mean)} us"
            f"; slowest block {' / '.join(f'{x:.2f}' for x in us[slow])} us"
            f", its slowest classification {r[5] / clock:.2f} us, lane 0's "
            f"{r[7]} node-start cells {r[6] / clock:.2f} us; blocks "
            f"{len(rows)} (at {clock:.0f} MHz)")


def pb_split(rows, clock):
    """The projection's per-lane sums: expansion, dedup, placement, trips."""
    rows = [r for r in rows if r[3]]
    mean = [sum(r[i] for r in rows) / len(rows) / clock for i in range(3)]
    slow = max(rows, key=lambda r: r[0] + r[1] + r[2])
    return (f"expansion/dedup or sort/placement a lane mean "
            f"{' / '.join(f'{x:.2f}' for x in mean)} us over "
            f"{sum(r[3] for r in rows) / len(rows):.1f} trips; slowest lane "
            f"{' / '.join(f'{slow[i] / clock:.2f}' for i in range(3))} us "
            f"over {slow[3]} trips (at {clock:.0f} MHz)")


def record(device):
    """{label: K1 args} and {label: projection args} of the runs."""
    from graphaligner_tpu_torch.core import engine_banded as eb
    from graphaligner_tpu_torch.io import load_fastq

    k1_calls, pb_calls = {}, {}
    state = {"corpus": None}
    orig_k1, orig_pb = eb.slice_cells, eb.project_band

    def rec_k1(*args, **kw):
        corpus = state["corpus"]
        if corpus is not None:
            key = (corpus, args[5].shape[0])
            old = k1_calls.get(key)
            if old is None or args[0].shape[1] > old[0].shape[1]:
                k1_calls[key] = [a.clone() for a in args]
        return orig_k1(*args, **kw)

    def rec_pb(*args, **kw):
        corpus = state["corpus"]
        if corpus is not None:
            pb_calls.setdefault(corpus, []).append(args)
        return orig_pb(*args, **kw)

    eb.slice_cells, eb.project_band = rec_k1, rec_pb
    fix = smoke.FIX
    d = f"{fix}/torch/converging_b35"
    with open(f"{d}/out_host.txt") as f:
        host = f.read().split()
    device_reads = [r.seq_id for r in load_fastq(f"{d}/reads.fastq")
                    if r.seq_id not in host]
    tile = -(-smoke.CV_READS // len(device_reads))
    runs = [
        ("converging", (f"{d}/graph.gfa", f"{d}/reads.fastq",
                        f"{d}/seeds.gam"), tile, host, None),
        ("multiallelic", (f"{fix}/torch/multiallelic_b35/graph.gfa",
                          f"{fix}/torch/multiallelic_b35/reads.fastq",
                          f"{fix}/torch/multiallelic_b35/seeds.gam"),
         smoke.TILE, (), None),
        ("longsim", (f"{fix}/longsim/graph.vg", f"{fix}/longsim/reads.fastq",
                     f"{fix}/longsim/seeds.gam"), smoke.TILE, (), None),
        ("longsim no reach", (f"{fix}/longsim/graph.vg",
                              f"{fix}/longsim/reads.fastq",
                              f"{fix}/longsim/seeds.gam"), smoke.TILE, (),
         "0"),
    ]
    try:
        for name, files, tile, drop, maxn in runs:
            graph, reads, seeds, _ = smoke.load_corpus(*files, tile=tile,
                                                       drop=drop)
            if maxn is not None:
                os.environ["GA_REACH_MAXN"] = maxn
            state["corpus"] = name
            try:
                _, wall, _, _ = smoke.run_corpus(device, graph, reads, seeds,
                                                 35, 0)
            finally:
                state["corpus"] = None
                os.environ.pop("GA_REACH_MAXN", None)
            print(f"{name} x{tile} -b 35: {len(reads)} reads in {wall:.2f} s",
                  flush=True)
    finally:
        eb.slice_cells, eb.project_band = orig_k1, orig_pb
    k1_out = {}
    for (corpus, Cm), args in sorted(k1_calls.items()):
        if corpus == "converging" or (corpus in ("multiallelic", "longsim")
                                      and Cm == 288):
            k1_out[f"{corpus} K_in={args[14].shape[1]} Cm={Cm}"] = args
    pb_out = {}
    for corpus in ("longsim no reach", "converging"):
        args = max(pb_calls[corpus], key=smoke.pb_slots)
        pb_out[f"{corpus} K_out={args[6].shape[1]}"] = args
    return k1_out, pb_out


def main() -> int:
    argv = sys.argv[1:]
    lanes = []
    if "--lanes" in argv:
        i = argv.index("--lanes")
        lanes = [int(x) for x in argv[i + 1].split(",")]
        del argv[i:i + 2]
    if len(argv) > 1:
        smoke.fail("usage: compare_k1_proj.py [DIR] [--lanes 2,4,8]")
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
    device = torch.device("cuda")
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import project_band as pb

    mods = {"this": (k1, pb)}
    if argv:
        mods["base"] = load_ops(argv[0], "ga_base_ops")
    for kmod, pmod in mods.values():
        kmod._build.library("banded_cell")
        pmod._build.library("project_band")
    smoke.run_corpus(device, *smoke.load_corpus(
        f"{smoke.FIX}/sim/bubbles.vg", f"{smoke.FIX}/sim/sim.fastq",
        f"{smoke.FIX}/sim/seeds.gam")[:3], 35, 0)  # warm-up
    k1_calls, pb_calls = record(device)
    clock = mhz()

    for label, args in k1_calls.items():
        Nm, B = args[0].shape
        Cm, K_in = args[5].shape[0], args[14].shape[1]
        want, plain_ms = smoke.timed(lambda: k1.slice_cells_plain(*args))
        outs = {}
        for tag, (kmod, _) in mods.items():
            outs[tag] = kmod.slice_cells(*args)
            for name, g, w in zip(("cols", "nm", "ctrl", "p_ids",
                                   "p_cell_send", "p_node_min", "p_node_end",
                                   "p_min"), outs[tag], want):
                if not torch.equal(g, w):
                    smoke.fail(f"{tag} K1 {name} differs from its plain "
                               f"version on {label}")
        order = ["base", "this", "this", "base"] if "base" in mods else \
            ["this", "this"]
        times = []
        for tag in order:
            kmod = mods[tag][0]
            times.append((tag, smoke.cuda_ms(
                lambda: kmod.slice_cells(*args), REPS)))
        moved, ops = smoke.k1_work(args, outs["this"])
        bms, by = smoke.bound(moved, ops, smoke.int32_rate())
        LB = k1.slice_lanes(Nm, Cm, K_in)
        print(f"K1 {label} Nm={Nm} B={B}: outputs bit-identical to the plain"
              f" version{' and between the two' if len(outs) > 1 else ''}; "
              f"in turns {', '.join(f'{t} {ms:.4f}' for t, ms in times)} ms; "
              f"plain {plain_ms:.1f} ms; bound {bms:.5f} ms by {by}; this: "
              f"{LB} lanes a block, {k1.slice_smem(Nm, Cm, LB, K_in)} B "
              f"shared [{card}]", flush=True)
        for tag, (kmod, _) in mods.items():
            split = split_reader(kmod, "banded_cell")
            if split is not None:
                n = -(-B // kmod.slice_lanes(Nm, Cm, K_in))
                rows = split(lambda: kmod.slice_cells(*args), n)
                print(f"  split ({tag}): {k1_split(rows, clock)}", flush=True)
        if lanes and K_in > k1.NARROW_K_IN:
            keep = k1.WIDE_LANES
            try:
                for n in lanes:
                    k1.WIDE_LANES = n
                    got = k1.slice_cells(*args)
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        smoke.fail(f"K1 at {n} lanes a block differs on "
                                   f"{label}")
                    ms = smoke.cuda_ms(lambda: k1.slice_cells(*args), REPS)
                    LB = k1.slice_lanes(Nm, Cm, K_in)
                    print(f"  this at {LB} lanes a block "
                          f"({k1.slice_smem(Nm, Cm, LB, K_in)} B shared): "
                          f"{ms:.4f} ms, bit-identical [{card}]", flush=True)
            finally:
                k1.WIDE_LANES = keep

    for label, args in pb_calls.items():
        B, Nm = args[0].shape
        log = []
        want, plain_ms = smoke.timed(
            lambda: pb.project_band_plain(*args, trip_log=log))
        outs = {}
        for tag, (_, pmod) in mods.items():
            outs[tag] = pmod.project_band(*args)
            for name, g, w in zip(("ids", "over"), outs[tag], want):
                if not torch.equal(g, w):
                    smoke.fail(f"{tag} projection {name} differs from its "
                               f"plain version on {label}")
        order = ["base", "this", "this", "base"] if "base" in mods else \
            ["this", "this"]
        times = []
        for tag in order:
            pmod = mods[tag][1]
            times.append((tag, smoke.device_ms(
                lambda: pmod.project_band(*args), REPS)))
        moved, ops = smoke.pb_work(args, outs["this"], log)
        bms, by = smoke.bound(moved, ops, smoke.int32_rate())
        trips = max(i + 1 for i, (_, need) in enumerate(log)
                    if bool(need.any()))
        print(f"projection {label} B={B} Nm={Nm}: outputs bit-identical to "
              f"the plain version; {trips} trips; in turns "
              f"{', '.join(f'{t} {ms:.4f}' for t, ms in times)} ms of device "
              f"time; plain {plain_ms:.2f} ms; bound {bms:.5f} ms by {by} "
              f"[{card}]", flush=True)
        for tag, (_, pmod) in mods.items():
            split = split_reader(pmod, "project_band")
            if split is not None:
                rows = split(lambda: pmod.project_band(*args), B)
                print(f"  split ({tag}): {pb_split(rows, clock)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
