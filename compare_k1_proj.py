#!/usr/bin/env python3
"""K1's wide route, the projection kernel and K2 on recorded calls, against
another checkout's kernels in turns, on one NVIDIA GPU.

    python3 compare_k1_proj.py [DIR] [--lanes 2,4,8] [--only k2]

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
events' interval back to back) as torch.profiler's device time. K2's
widest call of converging (its wide route at in-degree 80), of
multiallelic (in-degree 8) and of longsim (the narrow route) is held bit
for bit against walk_moves_plain(Bb=1) and timed between CUDA events, at
all its lanes and at 256 of them, with its bound as chip_smoke.py counts
it. core/batch_align.py's _consolidate_walk, which gathers those tables,
is run again on each corpus's widest call once the corpus's run has
ended, and timed on the host clock (synchronised): this checkout's, and
in turns DIR's (DIR, this, this, DIR), whose tables may be laid out
otherwise.

DIR is another checkout (``git archive <rev> graphaligner_tpu_torch | tar
-x -C DIR``, in a directory that .gitignore lists): its ops/ is imported
under another name, so its wrappers build DIR's csrc/ into DIR's own
build/kernels/. Each call is then also run through DIR's kernels, held
equal to this checkout's outputs, and the two are timed in turns (DIR,
this, this, DIR); K2's wide calls reach a DIR whose walk_moves has no
``lane_major`` in the lane-last layout. Where a library exports
``ga_split_read`` (a copy instrumented with clock64 stamps), the
per-phase clock split of a launch is printed too: K1's blocks' phases A,
A2, B and C (mean and slowest block), the slowest slot thread's
in-neighbour classification and lane 0's node-start cells; the
projection's expansion, dedup and placement summed over a lane's trips
(mean and slowest lane); K2's staging and its wait, the derived tables,
the step's head (the fast path inside a node), its slow block (node
starts, row 0: the chunks of in-neighbours) and the state update and
code packing, summed over a lane's slices and steps (mean and the
slowest lane).

--lanes times each wide K1 call of this checkout at other lanes a block
(``banded_cell.WIDE_LANES``); --only k2 times K2 alone. Prints the card's
name and power limit and one line a call; exits non-zero on any failure.
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
    """(banded_cell, project_band, walk_moves) of ROOT's
    graphaligner_tpu_torch/ops, the package imported as ``name``."""
    pkg_dir = os.path.join(os.path.abspath(root), "graphaligner_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return tuple(importlib.import_module(f"{name}.ops.{m}")
                 for m in ("banded_cell", "project_band", "walk_moves"))


def consolidate_of(name):
    """BandedBatchAligner._consolidate_walk of the package ``load_ops``
    imported as ``name``."""
    return importlib.import_module(
        f"{name}.core.batch_align").BandedBatchAligner._consolidate_walk


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


def k2_split(rows, clock):
    """K2's per-block stamps: 0 staging and its wait, 1 the derived tables,
    2 the step's head, 3 its slow block, 4 the state update and packing,
    5 steps, 6 slow steps | chunks << 32, 7 the block's cycles."""
    rows = [r for r in rows if r[5]]
    if not rows:
        return "no stamped steps"
    names = ("staging", "derive", "head", "slow", "pack")
    mean = [sum(r[i] for r in rows) / len(rows) / clock for i in range(5)]
    slow = max(rows, key=lambda r: r[7])
    steps, n_slow, chunks = slow[5], slow[6] & 0xFFFFFFFF, slow[6] >> 32
    rest = slow[7] - sum(slow[:5])
    per = " / ".join(f"{slow[i] / clock * 1e3 / steps:.1f}" for i in range(5))
    return (f"{' / '.join(names)} a lane mean "
            f"{' / '.join(f'{x:.1f}' for x in mean)} us over "
            f"{sum(r[5] for r in rows) / len(rows):.0f} steps; slowest lane "
            f"{' / '.join(f'{slow[i] / clock:.1f}' for i in range(5))} us, "
            f"the rest {rest / clock:.1f} us, of {slow[7] / clock:.1f} us "
            f"over {steps} steps ({per} ns a step; {n_slow} slow steps, "
            f"{chunks} chunks) (at {clock:.0f} MHz)")


def record(device, only_k2=False, cons_fns=()):
    """{label: K1 args}, {label: projection args}, {label: K2 call as
    chip_smoke.Recorder keeps it} and {corpus: (shape, times)} of the
    runs: each corpus's widest _consolidate_walk call, once the corpus's
    run has ended, through each (name, function) of cons_fns in turn
    (this checkout's where the name is "this")."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.core import engine_banded as eb
    from graphaligner_tpu_torch.io import load_fastq

    k1_calls, pb_calls, k2_calls, cons_times = {}, {}, {}, {}
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
    krec = smoke.Recorder()
    cons = smoke.ConsolidationRecorder()
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
    if only_k2:
        runs = runs[:3]
    try:
        for name, files, tile, drop, maxn in runs:
            graph, reads, seeds, _ = smoke.load_corpus(*files, tile=tile,
                                                       drop=drop)
            if maxn is not None:
                os.environ["GA_REACH_MAXN"] = maxn
            state["corpus"] = name
            krec.on = maxn is None
            cons.corpus = name if krec.on else None
            try:
                _, wall, _, _ = smoke.run_corpus(device, graph, reads, seeds,
                                                 35, 0)
            finally:
                state["corpus"] = cons.corpus = None
                os.environ.pop("GA_REACH_MAXN", None)
            if name in cons.calls:
                fns = [(tag, cons.orig if tag == "this" else fn)
                       for tag, fn in cons_fns]
                cons_times[name] = cons.time(name, fns)
            if krec.on:
                # the corpus's widest K2 call, its decode and its traces
                k2_calls[name] = max(krec.k2, key=lambda r: r[0][0].numel())
                krec.k2 = []
            print(f"{name} x{tile} -b 35: {len(reads)} reads in {wall:.2f} s",
                  flush=True)
    finally:
        cons.close()
        krec.close()
        eb.slice_cells, eb.project_band = orig_k1, orig_pb
    k1_out = {}
    for (corpus, Cm), args in sorted(k1_calls.items()):
        if corpus == "converging" or (corpus in ("multiallelic", "longsim")
                                      and Cm == 288):
            k1_out[f"{corpus} K_in={args[14].shape[1]} Cm={Cm}"] = args
    pb_out = {}
    for corpus in ("longsim no reach", "converging"):
        if corpus in pb_calls:
            args = max(pb_calls[corpus], key=smoke.pb_slots)
            pb_out[f"{corpus} K_out={args[6].shape[1]}"] = args
    return k1_out, pb_out, k2_calls, cons_times


def compare_k2(mods, label, call, cons, rate, card, clock):
    """One recorded K2 call: bit for bit against walk_moves_plain(Bb=1) and
    between the checkouts, timed in turns at all its lanes and at 256,
    its bound, the clock splits and its corpus's consolidation times."""
    import torch

    k2 = mods["this"][2]
    args, kw, outs, decode, traces = call
    K_in = kw["K_in"]
    K, Cm, Nm, B = k2.table_dims(args, K_in)
    want, plain_ms = smoke.timed(lambda: k2.walk_moves_plain(*args, **kw,
                                                             Bb=1))

    def call_of(tag, n):
        """(walk_moves, args, kwargs) of checkout ``tag`` at n lanes."""
        sub = smoke.k2_lanes(args, n, K_in)
        kmod = mods[tag][2]
        if k2.lane_major(K_in) and not hasattr(kmod, "lane_major"):
            # a checkout from before the lane-major layout
            sub = list(k2.lane_last_tables(sub[:6])) + sub[6:]
        return kmod.walk_moves, sub, kw

    order = ["base", "this", "this", "base"] if "base" in mods else \
        ["this", "this"]
    lines = []
    for n in (B, min(256, B)):
        calls = {tag: call_of(tag, n) for tag in mods}
        want_n = smoke.k2_lanes(want, n)
        for tag, (fn, a, k) in calls.items():
            smoke.k2_equal(fn(*a, **k), want_n, f"({tag}, {n} lanes) from "
                           f"walk_moves_plain(Bb=1) on {label}")
        times = [(tag, smoke.cuda_ms(lambda: calls[tag][0](
            *calls[tag][1], **calls[tag][2]), 5)) for tag in order]
        steps = int(want_n[3].max())
        lines.append(f"{n} lanes ({steps} steps in the longest): "
                     + ", ".join(f"{t} {ms:.3f} ms ({ms * 1e6 / steps:.1f} ns"
                                 " a step)" for t, ms in times))
    moved, ops = smoke.k2_work(args, outs, decode, traces, K_in)
    bms, by = smoke.bound(moved, ops, rate)
    buffers = 2 if k2.lane_major(K_in) else 1  # the wide route's two
    print(f"K2 {label} (K_in {K_in}) at K={K} Cm={Cm} Nm={Nm} B={B}: "
          f"bit-identical to walk_moves_plain(Bb=1)"
          f"{' and between the two' if len(mods) > 1 else ''}; in turns "
          f"{'; '.join(lines)}; plain {plain_ms:.1f} ms; bound {bms:.5f} ms "
          f"by {by}; this: {buffers} slice buffer(s), "
          f"{k2.smem_bytes(Cm, Nm, args[6].shape[0], K_in)} B "
          f"shared [{card}]", flush=True)
    if cons:
        print(f"  {smoke.consolidation_line(label, *cons, card)}", flush=True)
    for tag, mod in mods.items():
        split = split_reader(mod[2], "walk_moves")
        if split is not None:
            fn, a, k = call_of(tag, B)
            rows = split(lambda: fn(*a, **k), B)
            print(f"  split ({tag}): {k2_split(rows, clock)}", flush=True)


def main() -> int:
    argv = sys.argv[1:]
    lanes = []
    if "--lanes" in argv:
        i = argv.index("--lanes")
        lanes = [int(x) for x in argv[i + 1].split(",")]
        del argv[i:i + 2]
    only_k2 = False
    if "--only" in argv:
        i = argv.index("--only")
        only_k2 = argv[i + 1] == "k2"
        if not only_k2:
            smoke.fail("--only takes k2")
        del argv[i:i + 2]
    if len(argv) > 1:
        smoke.fail("usage: compare_k1_proj.py [DIR] [--lanes 2,4,8] "
                   "[--only k2]")
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
    from graphaligner_tpu_torch.ops import walk_moves as k2

    mods = {"this": (k1, pb, k2)}
    cons_fns = [("this", None)]
    if argv:
        mods["base"] = load_ops(argv[0], "ga_base")
        base_cons = consolidate_of("ga_base")
        cons_fns = [(tag, base_cons if tag == "base" else None)
                    for tag in ("base", "this", "this", "base")]
    for kmod, pmod, wmod in mods.values():
        kmod._build.library("banded_cell")
        pmod._build.library("project_band")
        wmod._build.library("walk_moves")
    smoke.run_corpus(device, *smoke.load_corpus(
        f"{smoke.FIX}/sim/bubbles.vg", f"{smoke.FIX}/sim/sim.fastq",
        f"{smoke.FIX}/sim/seeds.gam")[:3], 35, 0)  # warm-up
    k1_calls, pb_calls, k2_calls, cons = record(device, only_k2, cons_fns)
    clock = mhz()
    rate = smoke.int32_rate()
    for label, call in k2_calls.items():
        compare_k2(mods, label, call, cons.get(label), rate, card, clock)
    if only_k2:
        return 0

    for label, args in k1_calls.items():
        Nm, B = args[0].shape
        Cm, K_in = args[5].shape[0], args[14].shape[1]
        want, plain_ms = smoke.timed(lambda: k1.slice_cells_plain(*args))
        outs = {}
        for tag, (kmod, *_) in mods.items():
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
        for tag, (kmod, *_) in mods.items():
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
        for tag, (_, pmod, _) in mods.items():
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
        for tag, (_, pmod, _) in mods.items():
            split = split_reader(pmod, "project_band")
            if split is not None:
                rows = split(lambda: pmod.project_band(*args), B)
                print(f"  split ({tag}): {pb_split(rows, clock)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
