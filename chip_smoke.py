#!/usr/bin/env python3
"""Smoke run of graphaligner_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of graphaligner_tpu_torch/csrc/ with nvcc (sm_90a,
one nvcc per source, all at once) and the native host library with g++,
then drives the port's two paths through their public entry points under
GA_NO_FALLBACK=1:

- seeded banded mode (K1 slice_cells, the slice's metadata pass fused with
  its cell passes; K2 walk_moves): longsim tiled x10 (1,000 reads of
  ~10 kb, -b 35), sim at -b 35 and at -b 5 -B 20, ONT (25 reads of ~10 kb
  at ~18 % error on the longsim graph) at -b 35 and at -b 5 -B 20, every
  alignment byte for byte against the reference binary's goldens;
- its long-read mode (chained scan rounds that drop their columns, and a
  walk that recomputes them and chains K2 a window at a time): giant (3
  reads of 30 kb) and the 2 of huge's 4 reads of 100 kb (on a
  150,000-node graph) whose lanes fit 32 band nodes, at -b 35, and ONT at
  -b 5 -B 20 forced into it with LONG_WINDOW 48, against the same goldens,
  each corpus's wall split (from the port's tracer) into set-up, scan
  rounds, their replay, the walk's recompute and K2 windows, and the rest,
  with the windows a lane and the peak device memory above what the
  aligner's set-up holds; giant again in one normal-mode scan
  (LONG_WINDOW 640) and in rounds of 96, for their peaks; and huge's 4
  reads, which must raise under GA_NO_FALLBACK=1 (2 of them pass 32 band
  nodes at every capacity tier);
- the same seeded path with its bands projected by the projection kernel
  (``ops.project_band``, the JAX package's iterative ``pairwise`` mode):
  longsim x10, sim and ONT at both configs, giant and huge's 2 reads
  under GA_REACH_MAXN=0 (no graph gets a reach table) against the same
  goldens, and the big-graph corpus (tests/fixtures/torch/biggraph_b35:
  the synthetic variation graph at 2,625,000 digraph nodes, past the
  2,097,150 from which no reach table is built, checked against its
  stored checksum, and 100 reads of 10,048 bp at -b 35) against the JAX
  package's golden, with its set-up split and align time; then sim from
  a first tier of 8 node slots, and huge's 4 reads, which must raise;
- the same seeded path on a graph of in-degree 8, through K1's and K2's
  wide routes (the JAX package's XLA cell pass and XLA walk there):
  multiallelic x10 (tests/fixtures/torch/multiallelic_b35: 1,000 reads of
  about 10 kb on a variation graph of multi-allelic sites) at -b 35 and -b
  5 -B 20, with reach tables and under GA_REACH_MAXN=0, against the JAX
  package's goldens; its wide K1 call with the most lanes and its wide K2
  calls are held bit for bit against their plain versions (K2 at Bb=1,
  its plain moves decoded to the run's traces), and it is profiled once;
- the same seeded path past 32 in-neighbours (K2's chunks of 32, its
  16-bit move codes past 64, the projection at out-degree 80): converging
  x10 or more (tests/fixtures/torch/converging_b35: reads of about 10 kb
  on a graph whose converging trees join 33 to 80 leaves into one
  segment, in-degree 80) at -b 35 and -b 5 -B 20, with reach tables where
  ensure_reach builds one and without, against the JAX package's goldens,
  each launch shape's shared bytes and lanes a block printed; K1's call
  with the most lanes at each capacity tier (Cm 288, 576 and 1152) and
  one recorded call each of K2 and the projection are held bit for bit
  against their plain versions and timed, and converging -b 35 is
  profiled once (the wide K1's and the projection's summed device time,
  the idle share);
- the parallel modes (``graphaligner_tpu_torch.parallel``): longsim x10 at
  -b 35 on a mesh of two shards on the one card ([cuda:0, cuda:0]: every
  round split in two halves, each scanned and walked on its own), against
  the golden with its launches, its reads/s beside the unsharded run's in
  the same call and each shard's round-output bytes; ``make_mesh()`` over
  every visible card on sim at both configs; and two ``--coordinator``
  processes of the CLI on the card (torch.distributed over gloo), on sim at
  -b 35 (strided reads) and on ONT at -b 5 -B 20 (``--shard components``:
  the longsim graph is one component, so one process takes every read and
  the other writes an empty shard), their merged GAM byte for byte against
  one process's and equal to the golden, with the wall;
- exhaustive mode, -i, through ``align_reads``: K3's slice wavefront on
  the acyclic graphs — smallexample, sim (20 reads on bubbles.vg) and the
  longsim graph x the sim reads tiled x8 (160 lanes) — and K3's cyclic
  route on sim/cyclic.gfa x 32 reads through its repeat and on the longsim
  graph closed into a circle x 16 reads of 640 bp, half across the seam,
  every read byte for byte against the JAX-made goldens of
  tests/fixtures/torch/.
- the per-read host path (``--backend oracle``, no device) through
  align_reads on smallexample, sim -b 35 and sim -b 5 -B 20, the GAM and
  the per-read GAM and trace files against the reference binary's goldens,
  with the wall a read on the host clock; a named limit, with
  GA_NO_FALLBACK unset for it alone and then set: multiallelic_small at
  LONG_WINDOW 4 on the card launches the wide K1 and raises
  NotImplementedError where the long walk would start, its message naming
  --backend oracle, and nothing is realigned on the host; and the tools:
  simulate_reads -> the CLI on the card (its first 8 reads byte for byte
  against --backend oracle's) -> compare_alignments, with its counts.
  These phases' launches are printed apart and not added to the kernels
  line. Each phase's share of the wall is printed as it ends ([phase]).

Each path's kernel launches are counted over its run (each must be > 0,
the long path's K1 and K2 launches in long mode too; host-fallback lanes
must be 0). In runs of their own, two rounds each of giant and of ONT at
LONG_WINDOW 48 are recomputed and held bit for bit against their
originals, the widest long-mode K2 window of the ONT run against the plain
walk at Bb=1, and the last K1 call of huge's widest long-mode tier against
K1's plain version. Then each kernel is held against its plain
torch version on the card, on arguments recorded from that run: K1's eight
outputs bit for bit on its widest longsim call; for every K2 call its
moves, fail flags, state_out and used bit for bit against the plain walk at
Bb=1 (per lane, as the kernel steps), and the plain walk's moves decoded to
the main run's traces, then K2 on the widest call's table cut into a chain of two windows
and on its first 128 lanes padded to Cm=2304; the projection's ids and
over flags bit for bit on every call of the sim corpora without a reach
table, on the heaviest longsim x10 call, on the call with the most over
lanes beside live ones and on the heaviest big-graph call; K3's wavefront
six slabs bit
for bit on its sim call, and K3's cyclic route on sim/cyclic.gfa at pass
caps 1, 2 and 128 (one pass must flag every lane, 128 none), with its
passes and recomputed nodes per pass there and on the circle.
Each kernel's bound (the larger of its bytes over the memory rate and its
integer operations over the card's int32 issue rate) is computed from the
recorded arguments, K2's from the walk that ran, the cyclic route's on
sim/cyclic.gfa from the positions the plain version's passes show the
fixpoint needs. One more longsim x10 run
under torch.profiler, with reach tables and again under GA_REACH_MAXN=0,
gives the device-kernel count, busy time and idle share of the seeded
path, and K2's and the projection's launches and summed time there.

Prints the card's name and power limit, versions, build time, per-corpus
rates, one JSON line of kernel results, and last
{"ok": true, "device": {...}}. Exits non-zero on any failure, and at once
when CUDA is unavailable or the repository is not beside this script.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")
INT32_MAX = 2**31 - 1
TILE = 10
TILE_I = 8  # -i at the repo's scale: longsim graph x sim reads x8
# huge's reads whose forward pieces project more than 32 band nodes at every
# capacity tier (K1 packs 32 node slots; the graph has 8-bp nodes), at
# slices 564 and 211: the JAX package sends them to its host oracle too
HUGE_OVER_NM = ("read_1635367824", "read_604779437")
# the in-degree-8 corpus (a multi-allelic variation graph), tiled as longsim
# is, against the JAX package's goldens at both configs
MA_CORPORA = (("multiallelic x10 -b 35", 35, 0, "multiallelic_b35"),
              ("multiallelic x10 -b 5 -B 20", 5, 20, "multiallelic_b5_B20"))
# the in-degree-80 corpus (converging trees of 33 to 80 leaves), tiled to at
# least CV_READS reads, against the JAX package's goldens at both configs
CV_CORPORA = (("converging x{} -b 35", 35, 0, "converging_b35"),
              ("converging x{} -b 5 -B 20", 5, 20, "converging_b5_B20"))
CV_READS = 1000
# the big-graph corpus: bench_biggraph.py's graph (tests/biggraph_util.py),
# past the 2,097,150 nodes from which the scan projects without reach
BIG_SEGMENTS = 1_050_000
BIG_MIN_NODES = 2_097_150
# reads of the tools phase that the scalar oracle aligns again
ORACLE_READS = 8

# bound_ms: HBM rate of the H100 SXM (NVIDIA data sheet), and Hopper's 64
# INT32 lanes per SM (the architecture white paper), times the SM count and
# the card's maximum SM clock read below
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# integer operations per unit of work, counted from the kernels' sources
# (32-bit operations; a 64-bit word op counts as two)
K1_OPS_VALID_CELL = 110  # meta decode, chain Myers advance, fused column
K1_OPS_IDLE_CELL = 20  # decode and the INF column of a cell past the band
K1_OPS_PRED = 590  # pred advance + differenceMasks merge (wordops.cuh)
K1_OPS_CELL_META = 30  # a cell's slot, flags, code and old_end
K1_OPS_PAIR = 2  # a compare and a select per (slot, slot) pair matched
K2_OPS_STEP = 130  # one walk step: up to 3 candidate scores, K_in = 2
K2_OPS_SLOT = 6  # per band slot per walked slice: offsets, slot search
K3_OPS_CHAIN = 48  # one within-node Myers step, or a source's free start
PB_OPS_ENTRY = 12  # one projection entry: three gathers, tests, compaction
PB_OPS_SORT = 2  # a compare and a select per entry and sort merge level
# a node start merging its in-neighbours costs one pred advance and merge
# per in-neighbour, as K1 counts it (K1_OPS_PRED), whatever way the kernel
# merges


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def load_corpus(graph_file, reads_file, seeds_file, tile=1, drop=()):
    """(graph, reads, seeds, tiled name -> read name), the reads named in
    ``drop`` left out."""
    from graphaligner_tpu_torch.runtime.aligner import (
        load_alignment_graph,
        load_fastq,
        load_seed_hits,
    )

    graph = load_alignment_graph(graph_file)
    base = [r for r in load_fastq(reads_file) if r.seq_id not in drop]
    base_seeds = load_seed_hits(seeds_file, [r.seq_id for r in base])
    if tile == 1:
        return graph, base, base_seeds, {r.seq_id: r.seq_id for r in base}
    reads, seeds, names = [], {}, {}
    for t in range(tile):  # tiled the way bench.py tiles longsim
        for r in base:
            r2 = copy.copy(r)
            r2.seq_id = f"{r.seq_id}_t{t}"
            reads.append(r2)
            seeds[r2.seq_id] = base_seeds[r.seq_id]
            names[r2.seq_id] = r.seq_id
    return graph, reads, seeds, names


def check_golden(name, reads, names, results, golden_file):
    """Every read's GAM message equal to the golden's, with node ids mapped
    back from the doubled graph, as tests/test_differential.py compares."""
    from graphaligner_tpu_torch.runtime.aligner import stream, vg

    golden = {
        a.name: a for a in stream.read_messages(golden_file, vg.Alignment)
    }
    n_ok = 0
    for read in reads:
        res = results[read.seq_id]
        base = names[read.seq_id]
        if res.alignment_failed or res.alignment.score == INT32_MAX:
            if base in golden:
                fail(f"{name}/{read.seq_id}: reference aligned, port failed")
            continue
        mine = vg.Alignment.decode(res.alignment.encode())
        for m in mine.path.mapping:
            m.position.node_id //= 2
        mine.name = base
        if base not in golden:
            fail(f"{name}/{read.seq_id}: port aligned, reference failed")
        if mine != golden[base]:
            fail(f"{name}/{read.seq_id}: alignment differs from the golden")
        n_ok += 1
    return n_ok


def run_corpus(device, graph, reads, seeds, bw, ramp, window=None,
               aligner_cls=None, mesh=None):
    """(results, wall, cells, info) of one seeded run through
    align_reads_seeded_batch: info holds the aligner's set-up seconds (graph
    tables, reach table), its first tier's Cm, the run's peak device
    memory above what is held once the aligner is built ("peak"), and on a
    mesh the most bytes one round's outputs held on each shard, over the
    capacity tiers ("shard bytes")."""
    import torch

    from graphaligner_tpu_torch.core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
    )

    torch.cuda.synchronize(device)
    t0 = time.time()
    if mesh is None:
        aligner = (aligner_cls or BandedBatchAligner)(graph, bw, ramp, device)
    else:
        aligner = BandedBatchAligner(graph, bw, ramp, mesh=mesh)
    if window is not None:
        aligner.LONG_WINDOW = window
    torch.cuda.synchronize(device)
    setup = time.time() - t0
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    results = align_reads_seeded_batch(graph, aligner, reads, seeds)
    torch.cuda.synchronize(device)
    wall = time.time() - t0
    info = {"set-up": setup, "Cm": aligner.Cm, "held": held,
            "window": aligner.LONG_WINDOW,
            "reach": aligner._dt.reach is not None,
            "peak": torch.cuda.max_memory_allocated(device) - held}
    tiers, tier = [], aligner
    while tier is not None:
        tiers.append(tier.shard_bytes)
        tier = tier._bigger
    info["shard bytes"] = [max(col) for col in zip(*tiers)]
    cells = sum(results[r.seq_id].cells_processed for r in reads)
    return results, wall, cells, info


class Recorder:
    """Records the kernels' arguments at their call sites during the main
    path: the K1 (slice_cells) call with the most lanes, and every K2 call
    together with the decode call of its block and its decoded traces (if
    any of its lanes survived the walk)."""

    def __init__(self):
        import graphaligner_tpu_torch.core.batch_align as ba
        import graphaligner_tpu_torch.core.engine_banded as eb

        native = ba.native

        self.k1 = None
        # Cm -> the K1 call with the most lanes at that tier, when a dict
        self.k1_tiers = None
        # [args, kwargs, outputs of the run, decode args, decoded traces]
        self.k2 = []
        self.on = True  # record (off for corpora whose calls repeat shapes)
        self._mods = (eb, ba, native)
        self._orig = (eb.slice_cells, ba.walk_moves, native.decode_moves_batch)

        def rec_k1(*args, **kw):
            if self.on and (self.k1 is None
                            or args[0].shape[1] > self.k1[0][0].shape[1]):
                self.k1 = ([a.clone() for a in args], kw)
            tiers, Cm = self.k1_tiers, args[5].shape[0]
            if self.on and tiers is not None and (
                    Cm not in tiers
                    or args[0].shape[1] > tiers[Cm][0][0].shape[1]):
                tiers[Cm] = ([a.clone() for a in args], kw)
            return self._orig[0](*args, **kw)

        def rec_k2(*args, **kw):
            out = self._orig[1](*args, **kw)
            if self.on:
                self.k2.append([[a.clone() for a in args], kw,
                                [o.clone() for o in out], None, None])
            return out

        def rec_decode(*args, **kw):
            out = self._orig[2](*args, **kw)
            if self.on and self.k2 and self.k2[-1][3] is None:
                self.k2[-1][3] = (args[1:], kw)
                self.k2[-1][4] = out
            return out

        eb.slice_cells = rec_k1
        ba.walk_moves = rec_k2
        native.decode_moves_batch = rec_decode

    def close(self):
        eb, ba, native = self._mods
        eb.slice_cells, ba.walk_moves, native.decode_moves_batch = self._orig


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Device time a call of ``fn``, summed over every device event of
    ``reps`` calls under torch.profiler (kernels and memsets), or None
    when the profiler records no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    return sum(dev_us(e) for e in events) / 1e3 / reps


def timed(fn):
    """(result, ms) of one call, timed with CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def int32_rate() -> float:
    """int32 operations per second the card can issue: SMs x 64 INT32
    lanes x the maximum SM clock nvidia-smi reports."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    mhz = float(smi.stdout.strip().splitlines()[0])
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def bound(nbytes, ops, rate):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the int32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_work(args, outs):
    """(bytes, int32 operations) of one slice_cells call, counted from its
    data for one cell pass a lane (the longsim graph is acyclic). Bytes:
    every input read once — the band and the carries, the per-lane flags
    and scalars, the lane's 64-code window, the graph-table entries the
    bands name (node_len and node_start of each band node, its in-neighbour
    row, node_len of each previous-band node), the seq_codes word of each
    valid cell, bits_lut — and every output written once. Operations: per
    slot, the matches against the previous band and of its in-neighbours
    against both bands (K1_OPS_PAIR each); per cell its metadata and its
    DP (valid or idle); per in-band predecessor of a node start inside the
    cell array, one advance and merge."""
    import torch

    (ids, _, p_ids, _, _, p_cell_send, _, _, _, _, _, _, node_len, node_start,
     in_nbrs, _, bits_lut) = args
    Nm, B = ids.shape
    Cm = p_cell_send.shape[0]
    K_in = in_nbrs.shape[1]
    valid = ids < INT32_MAX
    safe = ids.clamp(0, node_len.shape[0] - 1).long()
    lens = torch.where(valid, node_len[safe], 0)
    cum = lens.cumsum(0)
    cells = cum[-1].clamp(max=Cm)  # valid cells a lane
    inside = valid & (cum - lens < Cm)  # node starts inside the array
    nb = torch.where(valid[..., None], in_nbrs[safe], -1)  # [Nm, B, K]
    in_band = (nb[:, None] == ids[None, :, :, None]).any(1) & (nb >= 0)
    preds = int((in_band & inside[..., None]).sum())
    n_valid, n_prev = int(valid.sum()), int((p_ids < INT32_MAX).sum())
    moved = (
        nbytes([a for i, a in enumerate(args) if i in (0, 1, 2, 3, 4, 5, 6, 7,
                                                       8, 9, 11)])
        + 64 * B + n_valid * (8 + 4 * K_in) + 4 * n_prev
        + 4 * int(cells.sum()) + nbytes([bits_lut]) + nbytes(outs)
    )
    ops = (n_valid * Nm * (1 + 2 * K_in) * K1_OPS_PAIR
           + Cm * B * K1_OPS_CELL_META
           + int(cells.sum()) * K1_OPS_VALID_CELL
           + int((Cm - cells).sum()) * K1_OPS_IDLE_CELL + preds * K1_OPS_PRED)
    return moved, ops


def compare_k1(call, rate, what):
    """A recorded K1 call against slice_cells_plain: its eight outputs bit
    for bit; timed, with its bound."""
    import torch

    from graphaligner_tpu_torch.ops import banded_cell as k1

    args, kw = call
    got = k1.slice_cells(*args, **kw)
    want, plain_ms = timed(lambda: k1.slice_cells_plain(*args, **kw))
    err = 0
    for name, g, w in zip(("cols", "nm", "ctrl", "p_ids", "p_cell_send",
                           "p_node_min", "p_node_end", "p_min"), got, want):
        diff = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        err = max(err, diff)
        if not torch.equal(g, w):
            fail(f"K1 {name} differs from its plain version on {what} "
                 f"(max {diff})")
    ms = cuda_ms(lambda: k1.slice_cells(*args, **kw), 20)
    Nm, B = args[0].shape
    Cm = args[5].shape[0]
    moved, ops = k1_work(args, got)
    bms, by = bound(moved, ops, rate)
    K_in = args[14].shape[1]
    LB = k1.slice_lanes(Nm, Cm, K_in)
    print(f"K1 slice_cells (fused) vs plain on {what} at Cm={Cm} Nm={Nm} "
          f"B={B}: eight outputs bit-identical; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms; bound {bms:.5f} ms by {by} ({moved} B, {ops} "
          f"int32 ops), share {bms / ms:.4f}; {LB} lanes a block, "
          f"{k1.slice_smem(Nm, Cm, LB, K_in)} B shared", flush=True)
    return err, ms, plain_ms, bms, by


def k2_work(args, outs, decode, traces, K_in):
    """(bytes, int32 operations) that one K2 call's walk needs, counted
    from the walk that ran. Bytes, per lane with a decoded trace: the packed
    column (20 B) of each cell (slice, position) the trace visits and of
    each candidate it must weigh there (the node's previous position, or at
    a node start each in-neighbour's last position); at row 0 the previous
    slice's last-row word (4 B) at those cells; the read code (1 B) of each
    row; the four band-table words (16 B) of each (slice, node) met. A lane
    without a trace (its walk failed) counts one column and one code a step.
    Every lane reads its 19 state words and writes its moves up to its last
    step and 18 words of flags and state. Operations: K2_OPS_STEP a step,
    K2_OPS_SLOT a band slot of each walked slice. The tables are in the
    layout of the route at in-degree K_in (``walk_moves.lane_major``)."""
    import numpy as np

    from graphaligner_tpu_torch.ops import walk_moves as k2

    Nm = k2.table_dims(args, K_in)[2]
    used = outs[3][0].cpu().numpy().astype(np.int64)
    sk_in = args[10][0].cpu().numpy().astype(np.int64)
    sk_out = outs[2][0].cpu().numpy().astype(np.int64)
    walked = np.where(used > 0, sk_in - sk_out + 1, 0)
    ops = int(used.sum()) * K2_OPS_STEP + int(walked.sum()) * Nm * K2_OPS_SLOT
    per = 32 // decode[1].get("code_bits", 4) if decode is not None else 8
    moved = 4 * 19 * len(used) + 4 * int((used // per + 1 + 18).sum())
    traced = np.zeros(len(used), dtype=bool)
    if decode is not None:
        (lanes, _, _, node_start, node_end, pos2node, in_nbrs, *_), _ = decode
        wk, rk, nk = traces
        BP, N = len(pos2node), len(node_start)
        for j, b in enumerate(lanes):
            n = int(nk[j])
            w, r = wk[j, :n], rk[j, :n]
            sl, node = r // 64, pos2node[w].astype(np.int64)
            start, r0 = w == node_start[node], r % 64 == 0
            cells = [(sl, w, node, r0),
                     (sl[~start], w[~start] - 1, node[~start], r0[~start])]
            for k in range(in_nbrs.shape[1]):
                p = in_nbrs[node, k].astype(np.int64)
                ok = start & (p >= 0)
                cells.append((sl[ok], node_end[p[ok]] - 1, p[ok], r0[ok]))
            c_sl, c_w, c_node, c_r0 = (np.concatenate(x) for x in zip(*cells))
            below = c_r0 & (c_sl > 0)
            moved += 20 * len(np.unique(c_sl * BP + c_w))
            moved += 4 * len(np.unique((c_sl[below] - 1) * BP + c_w[below]))
            moved += len(np.unique(r))
            moved += 16 * len(np.unique(c_sl * N + c_node))
            traced[b] = True
    moved += 21 * int(used[~traced].sum())
    return moved, ops


def k2_equal(got, want, what):
    """K2's four outputs bit for bit, or fail. Returns the largest
    |got - want| over them."""
    import torch

    err = 0
    for name, g, w in zip(("moves", "fail", "state_out", "used"), got, want):
        diff = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        err = max(err, diff)
        if not torch.equal(g, w):
            fail(f"K2 {name} differs {what} on {int((g != w).sum())} "
                 f"entries (max {diff})")
    return err


def k2_lanes(args, n, K_in=1):
    """A K2 call's first n lanes at in-degree K_in (every argument is
    lane-last but bits_lut and, on the wide route, the six tables, whose
    lanes are axis 1); or of its four outputs."""
    from graphaligner_tpu_torch.ops.walk_moves import lane_major

    major = lane_major(K_in)
    return [a if i == 6 and len(args) > 4
            else a[:, :n].contiguous() if major and i < 6
            else a[..., :n].contiguous() for i, a in enumerate(args)]


def k2_decode(moves, used, decode):
    """The native decode of a K2 call's moves, as core.batch_align runs
    it: (w, r, n) slabs of the recorded decode call's lanes."""
    import numpy as np

    from graphaligner_tpu_torch.core.batch_align import native

    dargs, dkw = decode
    per = 32 // dkw.get("code_bits", 4)
    rows = min(moves.shape[0], int(used.max()) // per + 1)
    return native.decode_moves_batch(
        np.ascontiguousarray(moves[:rows].cpu().numpy()).view(np.uint32),
        *dargs, **dkw,
    )


def k2_traces_equal(got, want, what):
    import numpy as np

    (wk, rk, nk), (ww, rw, nw) = got, want
    if not np.array_equal(nk, nw) or (nk < 1).any():
        fail(f"K2 decoded trace lengths differ {what}, or a lane is "
             "malformed")
    for j in range(len(nk)):
        n = int(nk[j])
        if not (np.array_equal(wk[j, :n], ww[j, :n])
                and np.array_equal(rk[j, :n], rw[j, :n])):
            fail(f"K2 decoded trace of lane {j} differs {what}")


def compare_k2(rec, rate, label="walk_moves"):
    """Every K2 call of the main path against walk_moves_plain at Bb=1 (per
    lane, as the kernel steps): moves, fail flags, state_out and used bit
    for bit, the largest difference kept as K2's error; the plain walk's
    moves decoded as the main run decoded the kernel's. Times the kernel at
    the widest call and at 256 of its lanes, and the plain walk at the
    widest call."""
    from graphaligner_tpu_torch.ops import _build
    from graphaligner_tpu_torch.ops import walk_moves as k2

    n_lanes = n_traces = err = 0
    largest = max(rec.k2, key=lambda r: r[0][0].numel())
    for call in rec.k2:
        args, kw, main_out, decode, traces = call
        got = k2.walk_moves(*args, **kw)
        k2_equal(got, main_out, "between two runs of the same call")
        want, ms_p = timed(lambda: k2.walk_moves_plain(*args, **kw, Bb=1))
        err = max(err, k2_equal(got, want, "from walk_moves_plain(Bb=1)"))
        if call is largest:
            plain_ms = ms_p
            rec.k2_plain = want  # k2_top_tier holds its lanes against it
        n_lanes += got[1].shape[1]
        if decode is not None:
            k2_traces_equal(k2_decode(want[0], want[3], decode), traces,
                            "between the plain walk and the main run")
            n_traces += len(traces[2])
    args, kw, outs, decode, traces = largest
    if decode is None:
        fail("no lane of the widest K2 call was decoded")
    K_in = kw["K_in"]
    K, Cm, Nm, B = k2.table_dims(args, K_in)
    buffers = 2 if k2.lane_major(K_in) else 1  # the wide route's two
    smem = k2.smem_bytes(Cm, Nm, args[6].shape[0], K_in)
    ms = cuda_ms(lambda: k2.walk_moves(*args, **kw), 3)
    moved, ops = k2_work(args, outs, decode, traces, K_in)
    bms, by = bound(moved, ops, rate)
    steps = int(outs[3].max())
    print(f"K2 {label} (K_in {kw['K_in']}) vs walk_moves_plain(Bb=1) over "
          f"{len(rec.k2)} "
          f"calls: moves, fail, state_out and used bit-identical on all "
          f"{n_lanes} lanes (max abs err {err}); the plain walk's moves decode "
          f"to the main run's {n_traces} traces; "
          f"one lane a block, {buffers} slice buffer(s), {smem} B shared; "
          f"at K={K} Cm={Cm} B={B} kernel {ms:.3f} ms ({steps} steps in "
          f"the longest lane, {ms * 1e6 / steps:.1f} ns a step), plain "
          f"{plain_ms:.1f} ms; bound {bms:.5f} ms by {by} ({moved} B, {ops} "
          f"int32 ops), share {bms / ms:.4f}", flush=True)
    n = min(256, B)
    sub = k2_lanes(args, n, K_in)
    ms_sub = cuda_ms(lambda: k2.walk_moves(*sub, **kw), 5)
    (lanes, *rest), dkw = decode
    keep = lanes < n
    sub_decode = ((lanes[keep], *[x[keep] for x in rest[:2]], *rest[2:]), dkw)
    m_sub, o_sub = k2_work(sub, k2_lanes(outs, n), sub_decode,
                           tuple(x[keep] for x in traces), K_in)
    b_sub, by_sub = bound(m_sub, o_sub, rate)
    print(f"K2 {label} at {n} of those lanes: kernel {ms_sub:.3f} ms; bound "
          f"{b_sub:.5f} ms by {by_sub} ({m_sub} B, {o_sub} int32 ops), share "
          f"{b_sub / ms_sub:.4f}", flush=True)
    for line in _build.BUILD_LOG.get("walk_moves", (0, ""))[1].splitlines():
        if "registers" in line or "stack" in line or "spill" in line:
            print(f"  [walk_moves ptxas] {line.strip()}", flush=True)
    return err, ms, plain_ms, bms, by


class ConsolidationRecorder:
    """Keeps, while ``corpus`` is set, the arguments of the widest call
    (by gathered elements) of BandedBatchAligner._consolidate_walk, one a
    corpus, and runs it again once that corpus's run has ended (``time``),
    so that the run's wall holds no extra work. The kept lanes hold their
    rounds' outputs on the card until then."""

    def __init__(self):
        from graphaligner_tpu_torch.core import batch_align as ba

        self.corpus = None
        self.calls = {}
        self._cls = ba.BandedBatchAligner
        orig = self.orig = self._cls._consolidate_walk

        def rec(aligner, *args, **kw):
            res = orig(aligner, *args, **kw)
            old = self.calls.get(self.corpus)
            if self.corpus is not None and (old is None
                                            or res[0].numel() > old[0]):
                self.calls[self.corpus] = (res[0].numel(),
                                           tuple(res[0].shape), aligner,
                                           args, kw)
            return res

        self._cls._consolidate_walk = rec

    def close(self):
        self._cls._consolidate_walk = self.orig

    def time(self, corpus, fns, reps=3):
        """(shape, [(name, seconds)]): the corpus's widest call through
        each (name, consolidate function) of fns in turn, each the least
        of reps runs on the host clock, synchronised before and after.
        Drops the call."""
        import torch

        _, shape, aligner, args, kw = self.calls.pop(corpus)
        times = []
        for name, fn in fns:
            best = float("inf")
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(aligner, *args, **kw)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            times.append((name, best))
        return shape, times


def consolidation_line(what, shape, times, card):
    return (f"_consolidate_walk on {what}'s widest walk call {shape}: "
            + ", ".join(f"{k} {v:.4f} s" for k, v in times)
            + f" (least of 3, host clock, synchronised, after the timed "
              f"run) [{card}]")


def k2_window_chain(rec):
    """The widest K2 call split at its middle slice m into two windows, as
    a windowed long-read walk chains them: the upper (slices m+1..K,
    win_base m) from the call's state, the lower from the kernel's
    state_out. Each window bit for bit against walk_moves_plain(Bb=1); the
    two move streams concatenated decode as the main run's did."""
    import torch

    from graphaligner_tpu_torch.ops import walk_moves as k2

    args, kw, outs, decode, traces = max(rec.k2,
                                         key=lambda r: r[0][0].numel())
    K = args[0].shape[0] - 1
    m = K // 2
    upper = [a[m:].contiguous() if i < 6 else a for i, a in enumerate(args)]
    upper[9] = torch.full_like(args[9], m)
    up = k2.walk_moves(*upper, **kw)
    k2_equal(up, k2.walk_moves_plain(*upper, **kw, Bb=1),
             "from walk_moves_plain(Bb=1) in the upper window")
    lower = [a[: m + 1].contiguous() if i < 6 else a
             for i, a in enumerate(args)]
    lower[10] = up[2]
    lo = k2.walk_moves(*lower, **kw)
    k2_equal(lo, k2.walk_moves_plain(*lower, **kw, Bb=1),
             "from walk_moves_plain(Bb=1) in the lower window")
    if bool(up[1].any()) or not torch.equal(lo[1], outs[1]):
        fail("K2's window chain failed lanes the single walk did not")
    chained = torch.cat([up[0], lo[0]])
    k2_traces_equal(
        k2_decode(chained, torch.tensor([chained.shape[0] * 8 - 1]), decode),
        traces, "across the window chain from the single walk's")
    started = int((args[10][0] > m).sum())
    print(f"K2 window chain at slice {m} of K={K}, B={args[0].shape[3]} "
          f"({started} lanes start in the upper window): both windows "
          f"bit-identical to the plain walk, {len(traces[2])} chained traces "
          f"as in the single walk", flush=True)


def k2_top_tier(rec):
    """The widest call's first 128 lanes with their columns padded from Cm
    to 2304, the top of the capacity ladder: bit for bit against the
    unpadded call's outputs and those lanes of the widest call's plain walk
    (compare_k2's; at Bb=1 every lane walks alone); timed."""
    import torch

    from graphaligner_tpu_torch.ops import walk_moves as k2

    args, kw = max(rec.k2, key=lambda r: r[0][0].numel())[:2]
    sub = k2_lanes(args, 128)
    K1, F, Cm, B = sub[0].shape
    padded = torch.zeros((K1, F, 2304, B), dtype=torch.int32,
                         device=sub[0].device)
    padded[:, :, :Cm] = sub[0]
    top = [padded] + sub[1:]
    got = k2.walk_moves(*top, **kw)
    k2_equal(got, k2_lanes(rec.k2_plain, 128),
             "from walk_moves_plain(Bb=1) at Cm=2304")
    k2_equal(got, k2.walk_moves(*sub, **kw), "at Cm=2304 from Cm=288")
    smem = k2.smem_bytes(2304, sub[1].shape[1], sub[6].shape[0])
    ms = cuda_ms(lambda: k2.walk_moves(*top, **kw), 3)
    print(f"K2 at Cm=2304 (K={K1 - 1}, B={B}, {smem} B shared): "
          f"bit-identical to the plain walk and to the "
          f"Cm={Cm} call; kernel {ms:.3f} ms", flush=True)


class LongRecorder:
    """What the long path's checks hold against the plain versions,
    recorded in runs of their own (not the measured ones): at K1's and
    K2's call sites, as Recorder records them, the last K1 call of the
    widest capacity tier while ``k1_on`` is set, and the widest K2 window
    of a long walk while ``k2_on`` is set; and through ``aligner`` (a
    BandedBatchAligner that clones its long-mode rounds before the run
    drops anything), the first two rounds of each ``corpus``."""

    NO_BASE = -(10**6)

    def __init__(self):
        import graphaligner_tpu_torch.core.batch_align as ba
        import graphaligner_tpu_torch.core.engine_banded as eb

        self.corpus = None
        self.k1_on = self.k2_on = False
        self.kept = []  # (aligner, round, {key: original output}, corpus)
        self.k1 = None  # (args, kwargs) of the recorded K1 call
        self.k2 = None  # [args, kwargs, outputs] of the widest K2 window
        self._walking = False
        self._mods = (eb, ba)
        self._orig = (eb.slice_cells, ba.walk_moves)
        rec = self

        def rec_k1(*args, **kw):
            if rec.k1_on and (rec.k1 is None or args[5].shape[0]
                              >= rec.k1[0][5].shape[0]):
                rec.k1 = ([a.clone() for a in args], kw)
            return rec._orig[0](*args, **kw)

        def rec_k2(*args, **kw):
            out = rec._orig[1](*args, **kw)
            if rec.k2_on and rec._walking and (
                    rec.k2 is None or args[0].numel() > rec.k2[0][0].numel()):
                rec.k2 = [[a.clone() for a in args], kw,
                          [o.clone() for o in out]]
            return out

        class Keeping(ba.BandedBatchAligner):
            def _round(self, *args, **kw):
                rnd = super()._round(*args, **kw)
                if self._long_mode and sum(
                        1 for k in rec.kept if k[3] == rec.corpus) < 2:
                    rec.kept.append((self, rnd, {
                        key: v.clone() for key, v in rnd.out.items()
                    }, rec.corpus))
                return rnd

            def _walk_long(self, *args, **kw):
                rec._walking = True
                try:
                    return super()._walk_long(*args, **kw)
                finally:
                    rec._walking = False

        self.aligner = Keeping
        eb.slice_cells = rec_k1
        ba.walk_moves = rec_k2

    def close(self):
        eb, ba = self._mods
        eb.slice_cells, ba.walk_moves = self._orig


def check_redispatch(lrec):
    """The rounds kept during the recording runs, recomputed on the card:
    every output, the dropped ones included, bit for bit equal to the
    original's."""
    import torch

    n = 0
    for aligner, rnd, orig, corpus in lrec.kept:
        again = aligner._redispatch_round(rnd)
        if set(orig) != set(again):
            fail(f"{corpus}: a recomputed round has other outputs")
        for key, want in orig.items():
            if not torch.equal(again[key], want):
                fail(f"{corpus}: a recomputed round's {key} differs from "
                     "the original")
        n += 1
    if n == 0 or not any(rnd.dropped for _, rnd, _, _ in lrec.kept):
        fail("no dropped long-mode round was kept to recompute")
    shapes = sorted({tuple(k[2]["cols"].shape) for k in lrec.kept})
    print(f"long mode: {n} rounds recomputed from their scan inputs, every "
          f"output bit-identical to the original, dropped cols included "
          f"(cols {', '.join('x'.join(map(str, s)) for s in shapes)})",
          flush=True)


def compare_k2_long(lrec, card):
    """The widest long-mode K2 window recorded, a window of a chained walk,
    against walk_moves_plain(Bb=1): its four outputs bit for bit; timed."""
    from graphaligner_tpu_torch.ops import walk_moves as k2

    if lrec.k2 is None:
        fail("no long-mode K2 call was recorded")
    args, kw, outs = lrec.k2
    got = k2.walk_moves(*args, **kw)
    k2_equal(got, outs, "between two runs of the same long-mode call")
    want, plain_ms = timed(lambda: k2.walk_moves_plain(*args, **kw, Bb=1))
    err = k2_equal(got, want, "from walk_moves_plain(Bb=1) in long mode")
    ms = cuda_ms(lambda: k2.walk_moves(*args, **kw), 3)
    K1_, _, Cm, B = args[0].shape
    active = int((args[9][0] > LongRecorder.NO_BASE).sum())
    print(f"K2 long-mode window (ont -b 5 -B 20 LONG_WINDOW 48) vs "
          f"walk_moves_plain(Bb=1) at K={K1_ - 1} Cm={Cm} B={B} ({active} "
          f"lanes in the window): moves, fail, state_out and used "
          f"bit-identical (max abs err {err}); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms [{card}]", flush=True)
    return err


class K3Recorder:
    """Records every K3 call of the -i run at its call site in core.engine:
    the corpus it served, its arguments (the schedule and Eq words, small)
    and its time on the card (CUDA events around the launch). Also splits
    each corpus's wall on the host clock: the BatchAligner's set-up
    (schedule, component order, initial slice) and compute_tables (K3, the
    copy of the slabs to the host, the per-node minima)."""

    def __init__(self):
        import torch

        from graphaligner_tpu_torch.core import engine

        self.calls = []  # (corpus, args, kwargs, ms)
        self.split = {}  # corpus -> {"setup": s, "tables": s}
        self.corpus = None
        self._engine = engine
        self._orig = (engine.exhaustive, engine.BatchAligner.__init__,
                      engine.BatchAligner.compute_tables)
        k3, init, tables = self._orig

        def rec(*args, **kw):
            out, ms = timed(lambda: k3(*args, **kw))
            self.calls.append((self.corpus, [a.clone() for a in args], kw, ms))
            return out

        def clocked(key, fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.time()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                split = self.split.setdefault(self.corpus, {})
                split[key] = split.get(key, 0.0) + time.time() - t0
                return out
            return run

        engine.exhaustive = rec
        engine.BatchAligner.__init__ = clocked("setup", init)
        engine.BatchAligner.compute_tables = clocked("tables", tables)

    def close(self):
        engine = self._engine
        (engine.exhaustive, engine.BatchAligner.__init__,
         engine.BatchAligner.compute_tables) = self._orig


def k3_work(args, steps=None):
    """(bytes, int32 operations) of one K3 call: inputs read once, the six
    [S, P, B] slabs and the flags written once; ``steps`` int64 [P], how
    many (slice, lane, pass) computations of each position the function
    needs (S x B, one pass, by default), each one Myers step at a position
    without in-neighbours and, at a node start, one pred advance and merge
    per in-neighbour."""
    import torch

    eq, code, is_start, _, preds, _ = args
    S, _, _, B = eq.shape
    P = code.shape[0]
    n_pred = ((preds >= 0) & is_start.to(torch.bool)[:, None]).sum(1).cpu()
    cost = torch.where(n_pred > 0, n_pred * K1_OPS_PRED, K3_OPS_CHAIN)
    if steps is None:
        steps = torch.full((P,), S * B, dtype=torch.int64)
    ops = int((steps.cpu() * cost.to(torch.int64)).sum())
    return nbytes(args) + 6 * S * P * B * 4 + B, ops


def k3_needed_steps(trace, args):
    """int64 [P]: the (slice, lane, pass) computations of each position the
    cyclic fixpoint needs, counted from exhaustive_plain's passes
    (``trace``), not from the kernel: every position in pass 1, and in each
    later pass up to a lane's confirming one, the positions of the nodes
    whose in-neighbours' end columns changed for that lane
    (``node_rule_marks``; a lane's marks are empty after it confirmed)."""
    import torch

    from graphaligner_tpu_torch.ops import exhaustive as k3

    _, _, is_start, _, preds, slot = args
    passes = {}
    for s, new in trace:
        passes.setdefault(s, []).append(new)
    P, B = passes[0][0].shape[1:]
    steps = torch.zeros(P, dtype=torch.int64, device=preds.device)
    old_end = torch.zeros((P, B), dtype=torch.int64, device=preds.device)
    for s in sorted(passes):
        steps += B
        for mark in k3.node_rule_marks(passes[s], old_end, is_start, preds,
                                       slot):
            steps += mark.sum(1)
        old_end = passes[s][-1][5]
    return steps.cpu()


def write_tiled_fastq(src, dst, tile):
    """The reads of ``src`` ``tile`` times over, read id suffixed _t<k>;
    returns {tiled id: base id}."""
    from graphaligner_tpu_torch.io import load_fastq

    names = {}
    with open(dst, "w") as f:
        for t in range(tile):
            for r in load_fastq(src):
                rid = f"{r.seq_id}_t{t}"
                names[rid] = r.seq_id
                f.write(f"@{rid}\n{r.sequence}\n+\n{r.quality}\n")
    return names


def run_exhaustive(graph_file, fastq_file, out_dir):
    """-i through the port's align_reads on the card: (alignments, wall)."""
    import torch

    from graphaligner_tpu_torch.core.params import AlignerParams
    from graphaligner_tpu_torch.runtime.aligner import align_reads

    params = AlignerParams(graph_file=graph_file, fastq_file=fastq_file,
                           initial_bandwidth=35, initial_full_band=True)
    torch.cuda.synchronize()
    t0 = time.time()
    alns = align_reads(params, log=lambda *a: None, output_dir=out_dir,
                       backend="cuda")
    torch.cuda.synchronize()
    return alns, time.time() - t0


def check_golden_i(name, names, alns, golden_file):
    """Every read's -i GAM message byte-identical to the JAX-made golden's
    under its base name; a read the golden lacks must fail here too."""
    from graphaligner_tpu_torch.io import stream, vg

    golden = {a.name: a.encode()
              for a in stream.read_messages(golden_file, vg.Alignment)}
    mine = {a.name: a for a in alns}
    if len(mine) != len(alns) or set(mine) - set(names):
        fail(f"{name}: unexpected or repeated alignment names")
    n_ok = 0
    for rid, base in names.items():
        aln = mine.get(rid)
        if aln is None:
            if base in golden:
                fail(f"{name}/{rid}: the golden aligned, the port failed")
            continue
        if base not in golden:
            fail(f"{name}/{rid}: the port aligned, the golden failed")
        aln.name = base
        if aln.encode() != golden[base]:
            fail(f"{name}/{rid}: alignment differs from the golden")
        n_ok += 1
    return n_ok


def compare_k3(rec, rate):
    """K3's wavefront against its plain version on the card, on the
    arguments of its sim -i call: all six slabs and the flags bit for bit.
    Also reports the bound of the longsim x8 launch beside its time in the
    main path."""
    from graphaligner_tpu_torch.ops import exhaustive as k3

    calls = [c for c in rec.calls if c[0] == "sim -i"]
    if len(calls) != 1:
        fail(f"expected one K3 call on sim -i, got {len(calls)}")
    _, args, kw, _ = calls[0]
    if kw["cyclic"]:
        fail("sim -i took K3's cyclic route")
    got = k3.exhaustive(*args, **kw)
    want, plain_ms = timed(lambda: k3.exhaustive_plain(*args, **kw))
    err = k3_equal(got, want, "in the wavefront from its plain version")
    ms = cuda_ms(lambda: k3.exhaustive(*args, **kw), 5)
    moved, ops = k3_work(args)
    bms, by = bound(moved, ops, rate)
    S, _, _, B = args[0].shape
    P = args[1].shape[0]
    print(f"K3 exhaustive wavefront vs plain at S={S} P={P} B={B}: six slabs "
          f"bit-identical; kernel {ms:.4f} ms (mean of 5), plain "
          f"{plain_ms:.1f} ms; bound {bms:.5f} ms by {by} ({moved} B, {ops} "
          f"int32 ops), share {bms / ms:.5f}", flush=True)
    for corpus, a, k, t in rec.calls:
        if corpus.startswith("longsim"):
            m, o = k3_work(a)
            b_ms, b_by = bound(m, o, rate)
            print(f"K3 wavefront in {corpus} at S={a[0].shape[0]} "
                  f"P={a[1].shape[0]} B={a[0].shape[3]}: {t:.3f} ms per "
                  f"launch; bound {b_ms:.4f} ms by {b_by} ({m} B, {o} int32 "
                  f"ops), share {b_ms / t:.5f}", flush=True)
    return err, ms, plain_ms, bms, by


def cyclic_reads(gfa, lanes, seed):
    """``lanes`` reads that walk the repeat cycle of sim/cyclic.gfa twice,
    mutated at 5 % from a numpy seed (as tests/test_engine.py makes its
    cyclic reads)."""
    import numpy as np

    seqs = {}
    with open(gfa) as f:
        for line in f:
            if line.startswith("S\t"):
                _, nid, seq = line.split()
                seqs[int(nid)] = seq
    truth = "".join(seqs[n] for n in (6, 7, 8, 9, 10, 11, 12, 8, 9, 10, 11,
                                      12, 13, 14))
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(lanes):
        mut = rng.random(len(truth)) < 0.05
        sub = rng.choice(list("ACGT"), len(truth))
        reads.append("".join(s if m else c
                             for c, s, m in zip(truth, sub, mut)))
    return reads


def pass_log_lines(log, P):
    """One line a slice of the cyclic route's pass log [S, cap, 3]: the
    passes its warps ran, then per pass the nodes recomputed (summed over
    the warps that ran it) and their positions' share of those warps' P."""
    lines = []
    for s, rows in enumerate(log.tolist()):
        ran = [r for r in rows if r[0] > 0]
        per = " ".join(f"{n}/{p / (w * P):.3f}" for w, n, p in ran)
        lines.append(f"    slice {s}: {len(ran)} passes; nodes/position "
                     f"share by pass: {per}")
    return lines


def k3_equal(got, want, what):
    """K3's six slabs and flags bit for bit, or fail; returns the largest
    |got - want|."""
    import torch

    err = 0
    for name, g, w in zip(("vp_lo", "vp_hi", "vn_lo", "vn_hi", "sbs", "send",
                           "nonconv"), got, want):
        diff = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        err = max(err, diff)
        if not torch.equal(g, w):
            fail(f"K3 {name} differs {what} (max {diff})")
    return err


def compare_k3_cyclic(rec, rate, card):
    """K3's cyclic route on the card, on the arguments of its cyclic -i
    call (sim/cyclic.gfa x 32 reads through its cycle): all six slabs and
    the flags bit for bit against the plain version at pass caps 1, 2 and
    128 (all lanes flagged at 1, none at 128). Prints the route's ptxas
    report, its launch shape, its pass log and its time there and on the
    circular -i call (the longsim graph closed into a circle). The bound
    counts the work the function needs, not what the kernel did: on cyclic
    -i the positions ``k3_needed_steps`` counts from the plain version's
    passes at cap 128; on the circle, where the plain version would take
    too long, a floor of two whole passes a slice."""
    import torch

    from graphaligner_tpu_torch.ops import _build
    from graphaligner_tpu_torch.ops import exhaustive as k3

    calls = {}
    for corpus in ("cyclic -i", "circular -i"):
        found = [c for c in rec.calls if c[0] == corpus]
        if len(found) != 1 or not found[0][2]["cyclic"]:
            fail(f"expected one K3 call on {corpus}, on the cyclic route")
        calls[corpus] = found[0]
    for line in _build.BUILD_LOG.get("exhaustive", (0, ""))[1].splitlines():
        if "cyclic" in line or "registers" in line or "spill" in line:
            print(f"  [exhaustive ptxas] {line.strip()}", flush=True)
    _, args, kw, _ = calls["cyclic -i"]
    err = 0
    for cap in (1, 2, 128):
        kc = dict(kw, max_passes=cap)
        got = k3.exhaustive(*args, **kc)
        trace = []
        want, ms_p = timed(lambda: k3.exhaustive_plain(*args, **kc,
                                                       trace=trace))
        err = max(err, k3_equal(got, want, f"from its plain version at cap "
                                           f"{cap}"))
        if cap == 128:
            plain_ms = ms_p
            needed = k3_needed_steps(trace, args)
        flagged = int(got[6].sum())
        if (cap == 1 and flagged != got[6].shape[0]) or (cap == 128
                                                         and flagged):
            fail(f"K3 cyclic at cap {cap} flagged {flagged} lanes")
        print(f"K3 cyclic vs plain on cyclic -i at cap {cap}: six slabs and "
              f"flags bit-identical, {flagged} of {got[6].shape[0]} lanes "
              f"flagged", flush=True)
    out = {}
    for corpus, (_, a, k, main_ms) in calls.items():
        k3.exhaustive(*a, **k)
        log = k3.PASS_LOG.cpu()
        S, _, _, B = a[0].shape
        P, K = a[4].shape
        N = k["num_nodes"]
        W, tab, sto, smem = k3.cyclic_shape(N, K, B)
        warps = -(-B // k3.WAVE_LANES)
        computed = int(log[:, :, 2].sum()) / (warps * S * P)
        if corpus == "cyclic -i":
            steps = needed
            how = (f"{int(needed.sum()) / (S * B * P):.4f} whole passes a "
                   f"lane and slice, counted from the plain version's passes")
        else:
            steps = torch.full((P,), 2 * S * B, dtype=torch.int64)
            how = "a floor of two whole passes a slice"
        moved, ops = k3_work(a, steps)
        bms, by = bound(moved, ops, rate)
        ms = cuda_ms(lambda: k3.exhaustive(*a, **k), 5 if P < 10_000 else 2)
        print(f"K3 cyclic on {corpus} at S={S} P={P} N={N} B={B}: {warps} "
              f"warps, {W} a block, tables in "
              f"{'shared' if tab else 'device'} memory, store in "
              f"{'shared' if sto else 'device'} memory, {smem} B shared; the "
              f"kernel computed {computed:.4f} whole passes a warp and slice; "
              f"kernel {ms:.4f} ms (main path {main_ms:.4f} ms); bound "
              f"{bms:.5f} ms by {by} ({moved} B, {ops} int32 ops at {how}), "
              f"share {bms / ms:.5f} [{card}]", flush=True)
        for line in pass_log_lines(log, P):
            print(line, flush=True)
        out[corpus] = (ms, bms, by)
    ms, bms, by = out["cyclic -i"]
    return err, ms, plain_ms, bms, by


def dev_us(event):
    """A device event's duration in us (torch renamed cuda_time_total)."""
    t = getattr(event, "device_time_total", None)
    return event.cuda_time_total if t is None else t


def profile_seeded(device, corpus, card, label="with reach tables",
                   name="longsim x10", walls=None):
    """A corpus (longsim x10) once more unprofiled (its wall; or ``walls``,
    the (wall, set-up) of a run of it at -b 35 already made) and once
    under torch.profiler at -b 35: device kernels (and copies) counted,
    their summed device time (one stream, so the busy time), the idle share
    of the unprofiled wall, the fused K1's launches (both routes), and K1's,
    K2's and the projection's launches and summed device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphaligner_tpu_torch.ops import banded_cell as k1

    graph, reads, seeds, _ = corpus
    if walls is None:
        _, wall, _, info = run_corpus(device, graph, reads, seeds, 35, 0)
        walls = (wall, info["set-up"])
    wall, setup = walls
    n1 = k1.LAUNCHES + k1.LAUNCHES_WIDE
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_corpus(device, graph, reads, seeds, 35, 0)
    wall_prof = time.time() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        print(f"profiled {name}: torch.profiler recorded no device "
              "events (device time not measured)", flush=True)
        return
    busy = sum(dev_us(e) for e in events) / 1e6
    k1_events = sum(1 for e in events if "slice_cells" in e.name)
    slices = k1.LAUNCHES + k1.LAUNCHES_WIDE - n1
    print(f"profiled {name} -b 35 ({label}): {len(events)} device "
          f"kernels and copies ({len(events) / max(slices, 1):.1f} a slice "
          f"over {slices} fused K1 launches, {k1_events} seen by the "
          f"profiler), device busy "
          f"{busy:.3f} s; unprofiled wall {wall:.3f} s, idle share "
          f"{1 - busy / wall:.3f}, of the alignment alone (the wall less the "
          f"aligner's set-up, {setup:.3f} s) "
          f"{1 - busy / (wall - setup):.3f} (profiled wall "
          f"{wall_prof:.3f} s) [{card}]", flush=True)
    for kernel in ("slice_cells", "walk_moves_kernel", "walk_moves_wide",
                   "project_band"):
        ev = [e for e in events if kernel in e.name]
        if ev:
            print(f"  {kernel}: {len(ev)} launches, "
                  f"{sum(dev_us(e) for e in ev) / 1e3:.3f} ms summed device "
                  f"time [{card}]", flush=True)
    by_name = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + dev_us(e) / 1e3)
    for name, (n, t) in sorted(by_name.items(), key=lambda x: -x[1][1])[:8]:
        print(f"  {t:9.3f} ms over {n:6d} x {name[:90]}", flush=True)


def bucket(S):
    """The scan-length bucket of a read of S slices, as BandedBatchAligner
    buckets it (160 and then doubling, past 160)."""
    b = 160
    while b < S:
        b *= 2
    return b


def long_split(snap) -> dict:
    """A long-mode run's split from the tracer's snapshot: host seconds of
    the scan rounds (their ``scan.*`` spans but the replay, not those of
    the walk's recomputes), their replay and the walk; the device seconds
    of the recomputes and K2 windows; the launches, lanes, lane-windows
    and allocator peaks."""
    from graphaligner_tpu_torch.utils.trace import seconds

    c = snap["counters"]
    out = {
        "scan rounds": seconds(snap, "scan.")
        - seconds(snap, "scan.", inside="walk.recompute")
        - seconds(snap, "scan.replay"),
        "replay": seconds(snap, "scan.replay"),
        "walk": seconds(snap, "walk."),
    }
    for key, name in (("recompute", "long.recompute_s"),
                      ("K2 windows", "long.k2_windows_s"),
                      ("k1 rounds", "long.k1_rounds"),
                      ("k1 recompute", "long.k1_recompute"),
                      ("k2", "long.k2"), ("lanes", "long.lanes"),
                      ("lane windows", "long.lane_windows"),
                      ("peak scan", "long.peak_scan_bytes"),
                      ("peak walk", "long.peak_walk_bytes")):
        if name in c:
            out[key] = c[name]
    return out


def run_long_path(device, card, ont):
    """The long-read path under GA_NO_FALLBACK=1: giant (3 reads of 30 kb,
    ~468 slices) and the 2 of huge's 4 reads of 100 kb (~1,560 slices, on a
    150,000-node graph) whose lanes fit 32 band nodes at -b 35, and ONT at
    -b 5 -B 20 with LONG_WINDOW 48 (ramp rewinds across dropped rounds),
    each against the reference binary's golden, with each corpus's wall
    split and its peak device memory. Then giant again at LONG_WINDOW 640
    (one normal-mode scan of 640 slices) and 96 (rounds of 96) against the
    same golden, for their peaks; huge's 4 reads, which must raise; and the
    recording runs of the checks. Returns the measured runs' K1 and K2
    launches and the recorder."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import walk_moves as k2
    from graphaligner_tpu_torch.utils import trace

    giant = load_corpus(f"{FIX}/longsim/graph.vg",
                        f"{FIX}/longsim/giant/giant_reads.fastq",
                        f"{FIX}/longsim/giant/giant_seeds.gam")
    huge = load_corpus(f"{FIX}/longsim/huge/graph.vg",
                       f"{FIX}/longsim/huge/reads.fastq",
                       f"{FIX}/longsim/huge/seeds.gam")
    hg, hreads, hseeds, hnames = huge
    huge_fit = (hg, [r for r in hreads if r.seq_id not in HUGE_OVER_NM],
                hseeds, hnames)
    giant_gold = f"{FIX}/longsim/giant/giant_out.gam"
    huge_gold = f"{FIX}/longsim/huge/golden.gam"
    ont_gold = f"{FIX}/ont/golden_b5B20.gam"
    corpora = [
        ("giant -b 35", giant, 35, 0, None, giant_gold),
        ("huge -b 35 (its 2 reads within 32 band nodes)", huge_fit, 35, 0,
         None, huge_gold),
        ("ont -b 5 -B 20 LONG_WINDOW 48", ont, 5, 20, 48, ont_gold),
    ]
    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    fb0 = ba.host_fallback_count()
    long_k1 = long_k2 = 0
    for name, (graph, reads, seeds, names), bw, ramp, window, golden in corpora:
        rw0 = ba.rewind_count()
        trace.enable()
        trace.reset()
        try:
            results, wall, cells, info = run_corpus(device, graph, reads,
                                                    seeds, bw, ramp, window)
            st = long_split(trace.snapshot())
        finally:
            trace.disable()
            trace.reset()
        n_ok = check_golden(name, reads, names, results, golden)
        if not st.get("k1 rounds") or not st.get("k2"):
            fail(f"{name}: did not run in long mode ({st})")
        long_k1 += st["k1 rounds"] + st.get("k1 recompute", 0)
        long_k2 += st["k2"]
        g = lambda key: st.get(key, 0.0)  # noqa: E731
        walk, redo, k2_s = g("walk"), g("recompute"), g("K2 windows")
        rest = wall - info["set-up"] - g("scan rounds") - g("replay") - walk
        S_b = bucket(max(len(r.sequence) for r in reads) // 64)
        Cm = info["Cm"]
        one = S_b * 7 * Cm * 4
        # K2's window buffer: the window's slices and the one below it, at
        # 128 lanes (every chunk here has fewer)
        buf = (min(info["window"], ba.max_window_slices(Cm, 32)) + 1) * 7 \
            * Cm * 128 * 4
        mib = lambda key: (st.get(key, info["held"])  # noqa: E731
                           - info["held"]) / 2**20
        print(f"{name}: {n_ok}/{len(reads)} aligned, byte-identical to the "
              f"golden; {len(reads) / wall:.3f} reads/s, "
              f"{cells / wall / 1e6:.1f} Mcells/s ({wall:.3f} s: set-up "
              f"{info['set-up']:.3f} s, scan rounds {g('scan rounds'):.3f} s,"
              f" their replay {g('replay'):.3f} s, walk {walk:.3f} s = "
              f"recompute {redo:.3f} s + K2 windows {k2_s:.3f} s (device "
              f"time) + the rest {walk - redo - k2_s:.3f} s, finalize "
              f"{rest:.3f} s); {g('lane windows') / max(g('lanes'), 1):.2f} "
              f"windows a lane over {int(g('lanes'))} walked lanes; ramp "
              f"rewinds {ba.rewind_count() - rw0}; long-mode launches K1 "
              f"{st['k1 rounds']} in rounds + {st.get('k1 recompute', 0)} in "
              f"recomputes, K2 {st['k2']}; peak device memory "
              f"{info['peak'] / 2**20:.1f} MiB above what the aligner's "
              f"set-up holds ({mib('peak scan'):.1f} MiB by the end of the "
              f"scan rounds, {mib('peak walk'):.1f} MiB by the end of the "
              f"walk, whose window buffer takes {buf / 2**20:.1f} MiB), "
              f"where one scan of the whole read (S_bucket {S_b}) would "
              f"hold {one / 2**20:.1f} MiB a lane in columns alone at "
              f"Cm={Cm} [{card}]", flush=True)
    launches = {"slice_cells": k1.LAUNCHES, "walk_moves": k2.LAUNCHES}
    fallbacks = ba.host_fallback_count() - fb0
    print(f"long-read path launches: K1 slice_cells {k1.LAUNCHES} (long-mode "
          f"rounds and recomputes {long_k1}), K2 walk_moves {k2.LAUNCHES} "
          f"(long-mode windows {long_k2}); host-fallback lanes {fallbacks}",
          flush=True)
    if min(long_k1, long_k2) < 1:
        fail("a kernel never launched in long mode")
    if fallbacks:
        fail(f"{fallbacks} lanes fell back to the host oracle")

    # the bound on memory: giant in one normal-mode scan of its bucket (640
    # slices fit the Cm=288 tier's 1648) and in long-mode rounds of 96
    graph, reads, seeds, names = giant
    for window in (640, 96):
        results, wall, _, info = run_corpus(device, graph, reads, seeds, 35,
                                            0, window)
        check_golden(f"giant LONG_WINDOW {window}", reads, names, results,
                     giant_gold)
        print(f"giant -b 35 at LONG_WINDOW {window} "
              f"({'normal mode' if window >= 640 else 'long mode'}): "
              f"byte-identical to the golden in {wall:.3f} s, peak device "
              f"memory {info['peak'] / 2**20:.1f} MiB above what the "
              f"aligner's set-up holds [{card}]", flush=True)

    lrec = LongRecorder()
    try:
        # huge's other 2 reads project more than 32 band nodes at every
        # tier: under GA_NO_FALLBACK=1 they must raise, not be realigned
        # on the host (K1's widest tier recorded on the way)
        lrec.k1_on = True
        try:
            run_corpus(device, hg, hreads, hseeds, 35, 0)
        except RuntimeError as e:
            if not (str(e).startswith("GA_NO_FALLBACK")
                    and any(r in str(e) for r in HUGE_OVER_NM)):
                raise
            print(f"huge -b 35, all 4 reads: raised under GA_NO_FALLBACK=1 "
                  f"({e}); reads {', '.join(HUGE_OVER_NM)} have no device "
                  f"alignment until band nodes past 32 are supported",
                  flush=True)
        else:
            fail("huge's lanes past 32 band nodes did not raise")
        lrec.k1_on = False
        for name, corpus, bw, ramp, window, golden in (corpora[0],
                                                       corpora[2]):
            graph, reads, seeds, names = corpus
            lrec.corpus = name
            lrec.k2_on = window is not None
            results, _, _, _ = run_corpus(device, graph, reads, seeds, bw,
                                          ramp, window, lrec.aligner)
            check_golden(f"{name} (recorded)", reads, names, results, golden)
    finally:
        lrec.close()
    return launches, lrec


class ProjRecorder:
    """Keeps references (no copies, no device sync) to the arguments of
    every project_band call of the scans, by corpus: the carries each call
    reads are fresh tensors a slice, never written in place."""

    def __init__(self):
        import graphaligner_tpu_torch.core.engine_banded as eb

        self.calls = {}  # corpus -> [args]
        self.corpus = None
        self._eb = eb
        self._orig = eb.project_band

        def rec(*args, **kw):
            if self.corpus is not None:
                self.calls.setdefault(self.corpus, []).append(args)
            return self._orig(*args, **kw)

        eb.project_band = rec

    def close(self):
        self._eb.project_band = self._orig


def run_big_graph(device, card):
    """The big-graph corpus (tests/fixtures/torch/biggraph_b35): the
    synthetic variation graph at 1,050,000 segments (2,625,000 digraph
    nodes, past 2,097,150, so no reach table is built and every band is
    projected by the kernel), checked against its stored checksum, and its
    100 reads of 10,048 bp at -b 35 against the JAX package's golden.
    Returns (projection launches, K1 launches) of its run."""
    import torch

    from graphaligner_tpu_torch.core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
    )
    from graphaligner_tpu_torch.core.tables import build_graph_tables
    from graphaligner_tpu_torch.graph.synthetic import (
        graph_checksum,
        make_big_graph,
    )
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import project_band as pb
    from graphaligner_tpu_torch.runtime.aligner import (
        load_fastq,
        load_seed_hits,
    )

    d = f"{FIX}/torch/biggraph_b35"
    t0 = time.time()
    graph, _, _ = make_big_graph(BIG_SEGMENTS)
    t_gen = time.time() - t0
    t0 = time.time()
    with open(f"{d}/graph.sha256") as f:
        if graph_checksum(graph) != f.read().split()[0]:
            fail("the big graph differs from the one its golden was made on")
    t_sum = time.time() - t0
    if graph.node_count < BIG_MIN_NODES:
        fail(f"the big graph has {graph.node_count} nodes")
    reads = load_fastq(f"{d}/reads.fastq")
    seeds = load_seed_hits(f"{d}/seeds.gam", [r.seq_id for r in reads])
    names = {r.seq_id: r.seq_id for r in reads}
    t0 = time.time()
    tables = build_graph_tables(graph)
    t_tab = time.time() - t0
    torch.cuda.synchronize(device)
    t0 = time.time()
    aligner = BandedBatchAligner(graph, 35, 0, device, _tables=tables)
    torch.cuda.synchronize(device)
    t_al = time.time() - t0
    if aligner._dt.reach is not None or tables.reach_dmax != -1:
        fail("a reach table was built for the big graph")
    n_pb, n_k1 = pb.LAUNCHES, k1.LAUNCHES
    t0 = time.time()
    results = align_reads_seeded_batch(graph, aligner, reads, seeds)
    torch.cuda.synchronize(device)
    t_align = time.time() - t0
    n_ok = check_golden("biggraph -b 35", reads, names, results,
                        f"{d}/out.gam")
    n_pb, n_k1 = pb.LAUNCHES - n_pb, k1.LAUNCHES - n_k1
    cells = sum(results[r.seq_id].cells_processed for r in reads)
    print(f"biggraph -b 35 ({graph.node_count:,} digraph nodes, "
          f"{int(graph.node_end[-1]):,} bp, no reach table): {n_ok}/"
          f"{len(reads)} aligned, byte-identical to the JAX golden; set-up "
          f"{t_gen + t_sum + t_tab + t_al:.3f} s = generator {t_gen:.3f} s "
          f"+ checksum {t_sum:.3f} s + graph tables {t_tab:.3f} s + aligner "
          f"(reverse positions, device tables) {t_al:.3f} s; align "
          f"{t_align:.3f} s ({len(reads) / t_align:.2f} reads/s, "
          f"{cells / t_align / 1e6:.1f} Mcells/s); projection launches "
          f"{n_pb} (two a slice) over {n_k1} slices [{card}]", flush=True)
    if n_pb < 1:
        fail("the projection kernel never launched on the big graph")
    return n_pb, n_k1


def run_no_reach_path(device, card, longsim, sim, ont):
    """The seeded path with its bands projected by the projection kernel:
    longsim x10, sim and ONT at both configs, giant and huge's 2 reads
    within 32 band nodes under GA_REACH_MAXN=0 (no graph gets a reach
    table) against the reference binary's goldens, then the big graph
    (past 2,097,150 nodes: no reach table by its size) against its JAX
    golden, all under GA_NO_FALLBACK=1; then, outside the launch count,
    sim from a first tier of 8 node slots and huge's 4 reads, which must
    raise. Returns the path's launches, the recorded projection calls and
    the big graph's (projection launches, slices)."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import project_band as pb
    from graphaligner_tpu_torch.ops import walk_moves as k2

    giant = load_corpus(f"{FIX}/longsim/graph.vg",
                        f"{FIX}/longsim/giant/giant_reads.fastq",
                        f"{FIX}/longsim/giant/giant_seeds.gam")
    hg, hreads, hseeds, hnames = load_corpus(
        f"{FIX}/longsim/huge/graph.vg", f"{FIX}/longsim/huge/reads.fastq",
        f"{FIX}/longsim/huge/seeds.gam")
    huge_fit = (hg, [r for r in hreads if r.seq_id not in HUGE_OVER_NM],
                hseeds, hnames)
    corpora = [
        ("longsim x10 -b 35", longsim, 35, 0, f"{FIX}/longsim/golden_b35.gam"),
        ("sim -b 35", sim, 35, 0, f"{FIX}/sim/golden_b35/out.gam"),
        ("sim -b 5 -B 20", sim, 5, 20, f"{FIX}/sim/golden_b5_B20/out.gam"),
        ("ont -b 35", ont, 35, 0, f"{FIX}/ont/golden_b35.gam"),
        ("ont -b 5 -B 20", ont, 5, 20, f"{FIX}/ont/golden_b5B20.gam"),
        ("giant -b 35", giant, 35, 0, f"{FIX}/longsim/giant/giant_out.gam"),
        ("huge -b 35 (its 2 reads within 32 band nodes)", huge_fit, 35, 0,
         f"{FIX}/longsim/huge/golden.gam"),
    ]
    rec = ProjRecorder()
    try:
        k1.LAUNCHES = k2.LAUNCHES = pb.LAUNCHES = 0
        fb0 = ba.host_fallback_count()
        os.environ["GA_REACH_MAXN"] = "0"
        try:
            for name, (graph, reads, seeds, names), bw, ramp, golden in corpora:
                rec.corpus = name
                results, wall, cells, info = run_corpus(device, graph, reads,
                                                        seeds, bw, ramp)
                n_ok = check_golden(f"{name} without a reach table", reads,
                                    names, results, golden)
                print(f"{name}, GA_REACH_MAXN=0: {n_ok}/{len(reads)} aligned,"
                      f" byte-identical to the golden; {len(reads) / wall:.1f}"
                      f" reads/s, {cells / wall / 1e6:.1f} Mcells/s ({wall:.2f}"
                      f" s, set-up {info['set-up']:.3f} s) [{card}]",
                      flush=True)
        finally:
            del os.environ["GA_REACH_MAXN"]
        rec.corpus = "biggraph -b 35"
        big = run_big_graph(device, card)
        launches = {"slice_cells": k1.LAUNCHES, "walk_moves": k2.LAUNCHES,
                    "project_band": pb.LAUNCHES}
        fallbacks = ba.host_fallback_count() - fb0
        print(f"no-reach path launches: projection {pb.LAUNCHES}, K1 "
              f"slice_cells {k1.LAUNCHES}, K2 walk_moves {k2.LAUNCHES}; "
              f"host-fallback lanes {fallbacks}", flush=True)
        if min(launches.values()) < 1:
            fail(f"a kernel of the no-reach path never launched: {launches}")
        if fallbacks:
            fail(f"{fallbacks} lanes fell back to the host oracle")
        os.environ["GA_REACH_MAXN"] = "0"
        try:
            # sim from a first tier of 8 node slots, for over lanes beside
            # live ones (they retry on the 16- and 32-slot tiers)
            rec.corpus = "sim -b 35 from Nm=8"
            graph, reads, seeds, names = sim
            aligner = ba.BandedBatchAligner(graph, 35, 0, device, Nm=8)
            check_golden(rec.corpus, reads, names, ba.align_reads_seeded_batch(
                graph, aligner, reads, seeds), f"{FIX}/sim/golden_b35/out.gam")
            # huge's other 2 reads pass 32 band nodes here too: they raise
            rec.corpus = "huge -b 35, all 4 reads"
            run_corpus(device, hg, hreads, hseeds, 35, 0)
        except RuntimeError as e:
            if not (str(e).startswith("GA_NO_FALLBACK")
                    and any(r in str(e) for r in HUGE_OVER_NM)):
                raise
            print(f"huge -b 35, all 4 reads, GA_REACH_MAXN=0: raised under "
                  f"GA_NO_FALLBACK=1 ({e})", flush=True)
        else:
            fail("huge's lanes past 32 band nodes did not raise without a "
                 "reach table")
        finally:
            del os.environ["GA_REACH_MAXN"]
    finally:
        rec.close()
    return launches, rec.calls, big


def run_wide_path(device, card):
    """The seeded path on a graph of in-degree 8 (K1's and K2's wide
    routes): multiallelic x10 at -b 35 and -b 5 -B 20, with reach tables and
    then under GA_REACH_MAXN=0 (the projection kernel), against the JAX
    package's goldens under GA_NO_FALLBACK=1, every count set to 0 before
    and read after. Records the K1 and K2 calls of the first run. Returns
    (launches, the Recorder, the tiled corpus)."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import project_band as pb
    from graphaligner_tpu_torch.ops import walk_moves as k2

    d = f"{FIX}/torch/multiallelic_b35"
    ma = load_corpus(f"{d}/graph.gfa", f"{d}/reads.fastq", f"{d}/seeds.gam",
                     tile=TILE)
    graph, reads, seeds, names = ma
    k1.LAUNCHES = k1.LAUNCHES_WIDE = k2.LAUNCHES = k2.LAUNCHES_WIDE = 0
    pb.LAUNCHES = 0
    fb0 = ba.host_fallback_count()
    rec = Recorder()
    cons = ConsolidationRecorder()
    try:
        for reach in (True, False):
            if not reach:
                os.environ["GA_REACH_MAXN"] = "0"
            try:
                for name, bw, ramp, golden in MA_CORPORA:
                    rec.on = reach and bw == 35
                    cons.corpus = name if rec.on else None
                    results, wall, cells, info = run_corpus(
                        device, graph, reads, seeds, bw, ramp)
                    cons.corpus = None
                    tag = "" if reach else ", GA_REACH_MAXN=0"
                    n_ok = check_golden(
                        name + tag, reads, names, results,
                        f"{FIX}/torch/{golden}/out.gam")
                    bp = sum(len(r.sequence) for r in reads)
                    print(f"{name}{tag}: {n_ok}/{len(reads)} aligned, "
                          f"byte-identical to the JAX golden; "
                          f"{len(reads) / wall:.1f} reads/s, "
                          f"{cells / wall / 1e6:.1f} Mcells/s, {bp / 1e6:.2f} "
                          f"Mbp in {wall:.2f} s (set-up {info['set-up']:.3f}"
                          f" s), peak device memory {info['peak'] / 2**20:.0f}"
                          f" MiB above the set-up [{card}]", flush=True)
                    if name in cons.calls:
                        print(consolidation_line(name, *cons.time(
                            name, [("lane-major", cons.orig)]), card),
                            flush=True)
            finally:
                os.environ.pop("GA_REACH_MAXN", None)
    finally:
        cons.close()
        rec.close()
    launches = {"slice_cells_wide": k1.LAUNCHES_WIDE,
                "walk_moves_wide": k2.LAUNCHES_WIDE,
                "project_band": pb.LAUNCHES, "slice_cells": k1.LAUNCHES,
                "walk_moves": k2.LAUNCHES}
    fallbacks = ba.host_fallback_count() - fb0
    print(f"wide path launches (in-degree 8): K1 wide {launches['slice_cells_wide']}"
          f", K2 wide {launches['walk_moves_wide']}, projection "
          f"{launches['project_band']}, narrow K1 {k1.LAUNCHES} and K2 "
          f"{k2.LAUNCHES}; host-fallback lanes {fallbacks}", flush=True)
    if min(launches["slice_cells_wide"], launches["walk_moves_wide"],
           launches["project_band"]) < 1:
        fail(f"a kernel of the wide path never launched: {launches}")
    if k1.LAUNCHES or k2.LAUNCHES:
        fail(f"a narrow route ran on a graph of in-degree 8: {launches}")
    if fallbacks:
        fail(f"{fallbacks} lanes fell back to the host oracle")
    if rec.k1 is None or not rec.k2:
        fail("the wide kernels' arguments were not recorded")
    return launches, rec, ma


class ShapeRecorder:
    """Counts the calls of K1, K2 and the projection by launch shape
    (each K1 and K2 call one launch, each projection call two), for the
    shared bytes and lanes a block of each."""

    def __init__(self):
        import graphaligner_tpu_torch.core.batch_align as ba
        import graphaligner_tpu_torch.core.engine_banded as eb

        self.shapes = {}
        self._mods = (eb, ba)
        self._orig = (eb.slice_cells, ba.walk_moves, eb.project_band)

        def count(key):
            self.shapes[key] = self.shapes.get(key, 0) + 1

        def k1(*args, **kw):
            count(("K1", args[5].shape[0], args[0].shape[0],
                   args[14].shape[1]))
            return self._orig[0](*args, **kw)

        def k2(*args, **kw):
            from graphaligner_tpu_torch.ops import walk_moves as k2mod

            _, Cm, Nm, B = k2mod.table_dims(args, kw["K_in"])
            count(("K2", Cm, Nm, args[6].shape[0], kw["K_in"], B))
            return self._orig[1](*args, **kw)

        def proj(*args, **kw):
            count(("projection", args[0].shape[1], args[6].shape[1]))
            return self._orig[2](*args, **kw)

        eb.slice_cells, ba.walk_moves, eb.project_band = k1, k2, proj

    def close(self):
        eb, ba = self._mods
        eb.slice_cells, ba.walk_moves, eb.project_band = self._orig

    def report(self, card):
        """One line a launch shape: its calls, lanes a block and shared
        bytes, as the wrappers size them."""
        from graphaligner_tpu_torch.ops import banded_cell as k1
        from graphaligner_tpu_torch.ops import project_band as pb
        from graphaligner_tpu_torch.ops import walk_moves as k2

        for key, n in sorted(self.shapes.items()):
            if key[0] == "K1":
                _, Cm, Nm, K_in = key
                LB = k1.slice_lanes(Nm, Cm, K_in)
                what = (f"K1 wide at Cm={Cm} Nm={Nm} K_in={K_in}: {n} "
                        f"launches, {LB} lanes a block, "
                        f"{k1.slice_smem(Nm, Cm, LB, K_in)} B shared")
            elif key[0] == "K2":
                _, Cm, Nm, R, K_in, B = key
                what = (f"K2 wide at Cm={Cm} Nm={Nm} K_in={K_in} B={B}: {n} "
                        f"launches, one lane a block, two slice buffers, "
                        f"{k2.smem_bytes(Cm, Nm, R, K_in)} B shared "
                        f"({32 // k2.codes_per_word(K_in)}-bit move codes)")
            else:
                _, Nm, K_out = key
                LB = pb.project_lanes(Nm, K_out)
                what = (f"projection at Nm={Nm} K_out={K_out}: {2 * n} "
                        f"launches ({n} calls), {LB} lanes a block, "
                        f"{pb.project_smem(Nm, K_out, LB)} B shared")
            print(f"  {what} [{card}]", flush=True)


def converging_codes(rec):
    """The widest in-neighbour index of any H or D through an in-neighbour
    among the recorded K2 calls' moves (16-bit codes past 64
    in-neighbours, bytes up to 64)."""
    import torch

    from graphaligner_tpu_torch.ops import walk_moves as k2

    widest = -1
    for args, kw, outs, _, _ in rec.k2:
        bits = k2.code_bits(kw["K_in"])
        h0, d0 = k2.move_bases(kw["K_in"])
        span = h0 if bits > 4 else 4  # the in-neighbours a code range holds
        m = outs[0].to(torch.int64) & 0xFFFFFFFF
        for j in range(32 // bits):
            c = (m >> (bits * j)) & ((1 << bits) - 1)
            for base in (h0, d0):
                k = torch.where((c >= base) & (c < base + span), c - base, -1)
                widest = max(widest, int(k.max()))
    return widest


def run_converging_path(device, card):
    """The seeded path on a graph of in-degree past 32 (K1's and K2's wide
    routes over in-neighbours in chunks of 32, 16-bit move codes past 64,
    the projection at out-degree past 32): the converging corpus
    (tests/fixtures/torch/converging_*, converging trees of 33 to 80
    leaves) at -b 35 and -b 5 -B 20, its reads that the JAX package aligned
    on its device tiled to at least CV_READS, with reach tables where
    ensure_reach builds one and under GA_REACH_MAXN=0, against the JAX
    package's goldens under GA_NO_FALLBACK=1, every count set to 0 before
    and read after; then, outside the count, the reads it sent to its host
    oracle (their lanes pass 32 band nodes at every tier), which must
    raise. Prints each launch shape's shared bytes and lanes a block.
    Records the K1 and K2 calls of the first run and the projection calls
    of the first run without reach tables. Returns (launches, the
    Recorder, the projection calls)."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.io import load_fastq
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import project_band as pb
    from graphaligner_tpu_torch.ops import walk_moves as k2

    corpora = []
    for name, bw, ramp, golden in CV_CORPORA:
        d = f"{FIX}/torch/{golden}"
        with open(f"{d}/out_host.txt") as f:
            host = f.read().split()
        device_reads = [r.seq_id for r in load_fastq(f"{d}/reads.fastq")
                        if r.seq_id not in host]
        tile = -(-CV_READS // len(device_reads))
        corpus = load_corpus(f"{d}/graph.gfa", f"{d}/reads.fastq",
                             f"{d}/seeds.gam", tile=tile, drop=host)
        corpora.append((name.format(tile), bw, ramp, golden, corpus, host))
    k1.LAUNCHES = k1.LAUNCHES_WIDE = k2.LAUNCHES = k2.LAUNCHES_WIDE = 0
    pb.LAUNCHES = 0
    fb0 = ba.host_fallback_count()
    rec = Recorder()
    rec.k1_tiers = {}
    prec = ProjRecorder()
    shapes = ShapeRecorder()
    cons = ConsolidationRecorder()
    modes = [True, False]
    walls = None  # the first run's (wall, set-up), for the profile
    try:
        while modes:
            reach = modes.pop(0)
            if not reach:
                os.environ["GA_REACH_MAXN"] = "0"
            try:
                for name, bw, ramp, golden, corpus, host in corpora:
                    graph, reads, seeds, names = corpus
                    rec.on = rec.k1 is None
                    cons.corpus = name if rec.on else None
                    prec.corpus = None if reach or prec.calls else name
                    results, wall, cells, info = run_corpus(
                        device, graph, reads, seeds, bw, ramp)
                    cons.corpus = None
                    walls = walls or (wall, info["set-up"])
                    if reach and not info["reach"]:
                        # ensure_reach rejected the graph: every band is
                        # projected by the kernel, and the phase runs once
                        print(f"{name}: ensure_reach builds no reach table "
                              "for this graph; every band is projected by "
                              "the kernel, so the phase runs once",
                              flush=True)
                        modes = []
                        reach = False
                    tag = "" if reach else ", no reach table"
                    n_ok = check_golden(
                        name + tag, reads, names, results,
                        f"{FIX}/torch/{golden}/out.gam")
                    bp = sum(len(r.sequence) for r in reads)
                    print(f"{name}{tag} ({len(reads) // len(set(names.values()))}"
                          f" x {len(set(names.values()))} reads, the JAX "
                          f"package's host oracle took {len(host)} others): "
                          f"{n_ok}/{len(reads)} aligned, "
                          f"byte-identical to the JAX golden; "
                          f"{len(reads) / wall:.1f} reads/s, "
                          f"{cells / wall / 1e6:.1f} Mcells/s, {bp / 1e6:.2f} "
                          f"Mbp in {wall:.2f} s (set-up {info['set-up']:.3f}"
                          f" s), peak device memory {info['peak'] / 2**20:.0f}"
                          f" MiB above the set-up [{card}]", flush=True)
                    if name in cons.calls:
                        print(consolidation_line(name, *cons.time(
                            name, [("lane-major", cons.orig)]), card),
                            flush=True)
            finally:
                os.environ.pop("GA_REACH_MAXN", None)
    finally:
        cons.close()
        shapes.close()
        prec.close()
        rec.close()
    launches = {"slice_cells_wide": k1.LAUNCHES_WIDE,
                "walk_moves_wide": k2.LAUNCHES_WIDE,
                "project_band": pb.LAUNCHES, "slice_cells": k1.LAUNCHES,
                "walk_moves": k2.LAUNCHES}
    fallbacks = ba.host_fallback_count() - fb0
    k_in = max(key[3] for key in shapes.shapes if key[0] == "K1")
    widest = converging_codes(rec)
    print(f"converging path launches (in-degree {k_in}): K1 wide "
          f"{launches['slice_cells_wide']}, K2 wide "
          f"{launches['walk_moves_wide']}, projection "
          f"{launches['project_band']}, narrow K1 {k1.LAUNCHES} and K2 "
          f"{k2.LAUNCHES}; host-fallback lanes {fallbacks}; the first run's "
          f"walks moved through in-neighbours up to index {widest}",
          flush=True)
    shapes.report(card)
    if min(launches["slice_cells_wide"], launches["walk_moves_wide"],
           launches["project_band"]) < 1:
        fail(f"a kernel of the converging path never launched: {launches}")
    if k1.LAUNCHES or k2.LAUNCHES:
        fail(f"a narrow route ran on a graph of in-degree {k_in}: "
             f"{launches}")
    if k_in <= 64 or widest < 64:
        fail(f"the converging path did not walk past 64 in-neighbours "
             f"(in-degree {k_in}, widest move through in-neighbour "
             f"{widest})")
    if fallbacks:
        fail(f"{fallbacks} lanes fell back to the host oracle")
    if rec.k1 is None or not rec.k2 or not prec.calls:
        fail("the converging phase's kernel arguments were not recorded")
    # the reads the JAX package's host oracle took: under GA_NO_FALLBACK=1
    # they must raise, not be realigned on the host
    for name, bw, ramp, golden, corpus, host in corpora:
        if not host:
            continue
        d = f"{FIX}/torch/{golden}"
        graph, reads, seeds, _ = load_corpus(
            f"{d}/graph.gfa", f"{d}/reads.fastq", f"{d}/seeds.gam")
        try:
            run_corpus(device, graph, [r for r in reads if r.seq_id in host],
                       seeds, bw, ramp)
        except RuntimeError as e:
            if not (str(e).startswith("GA_NO_FALLBACK")
                    and any(repr(r) in str(e) for r in host)):
                raise
            print(f"{name}, the {len(host)} reads the JAX package sent to "
                  f"its host oracle ({', '.join(host)}) untiled: raised under "
                  f"GA_NO_FALLBACK=1 ({e})", flush=True)
        else:
            fail(f"{name}: the reads past 32 band nodes did not raise")
    return (launches, rec, next(iter(prec.calls.values())), corpora[0][4],
            walls)


def pb_work(args, outs, log):
    """(bytes, int32 operations) of one project_band call, counted from the
    trips its lanes need (the plain version's trip log: a live lane up to
    its fixpoint, the others to the batch's count). Bytes: the band inputs
    and per-lane scalars read once, for each lane the table entries of its
    widest trip (an out-neighbour row, a length and a rank each), the
    outputs written once. Operations: each entry of each needed trip formed
    (PB_OPS_ENTRY), then deduplicated and rank-ordered as one sort
    (PB_OPS_SORT per entry and merge level)."""
    import torch

    K_out = args[6].shape[1]
    ops = 0
    widest = torch.zeros_like(log[0][0])
    for ev, need in log:
        widest = torch.maximum(widest, ev)
        e = ev.double()
        levels = torch.ceil(torch.log2(e.clamp(min=2)))
        ops += int((need * (PB_OPS_ENTRY * e + PB_OPS_SORT * e * levels))
                   .sum())
    moved = (nbytes(args[:6]) + int(widest.sum()) * (4 * K_out + 8)
             + nbytes(outs))
    return moved, ops


def pb_check(args, what):
    """A recorded projection call against project_band_plain: ids and over
    bit for bit, or fail. Returns (outputs, the plain version's trip log,
    its ms, the largest difference)."""
    import torch

    from graphaligner_tpu_torch.ops import project_band as pb

    got = pb.project_band(*args)
    log = []
    want, plain_ms = timed(lambda: pb.project_band_plain(*args, trip_log=log))
    err = 0
    for g, w, name in zip(got, want, ("ids", "over")):
        diff = int((g.long() - w.long()).abs().max())
        err = max(err, diff)
        if not torch.equal(g, w):
            fail(f"project_band {name} differs from its plain version on "
                 f"{what} (max {diff})")
    return got, log, plain_ms, err


def pb_timed(args, rate, card, what):
    """A recorded projection call held against its plain version, timed,
    with its bound: (max abs err, ms, plain ms, bound ms, bound by)."""
    from graphaligner_tpu_torch.ops import project_band as pb

    got, log, plain_ms, err = pb_check(args, what)
    # back to back, the wrapper's host-side launch cost sets the events'
    # interval: the kernels' own time is the profiler's device time
    ev_ms = cuda_ms(lambda: pb.project_band(*args), 20)
    ms = device_ms(lambda: pb.project_band(*args), 20) or ev_ms
    moved, ops = pb_work(args, got, log)
    bms, by = bound(moved, ops, rate)
    B, Nm = args[0].shape
    trips = max(i + 1 for i, (_, need) in enumerate(log) if bool(need.any()))
    print(f"project_band vs plain on {what} at B={B} Nm={Nm} "
          f"K_out={args[6].shape[1]}: ids and over bit-identical; {trips} "
          f"trips, {int(got[1].sum())} over lanes; kernel {ms:.4f} ms of "
          f"device time (two launches and a memset; {ev_ms:.4f} ms between "
          f"CUDA events a call back to back), plain {plain_ms:.2f} ms; bound "
          f"{bms:.5f} ms by {by} ({moved} B, {ops} int32 ops), share "
          f"{bms / ms:.4f} [{card}]", flush=True)
    return err, ms, plain_ms, bms, by


def pb_slots(args):
    """The previous-band slots a projection call reads."""
    return int((args[0] < INT32_MAX).sum())


def compare_pb(calls, rate, card):
    """The projection kernel against project_band_plain on recorded calls:
    every call of the sim corpora, then the heaviest longsim x10 call (the
    most previous-band slots), the call with the most over lanes beside
    live ones, and the heaviest big-graph call (its bands' ranks past
    2,097,151), bit for bit; the last three timed, with their bounds."""
    from graphaligner_tpu_torch.ops import project_band as pb

    err = 0
    n = 0
    for name in ("sim -b 35", "sim -b 5 -B 20"):
        for args in calls[name]:
            err = max(err, pb_check(args, f"a {name} call")[3])
            n += 1
    print(f"project_band vs plain: all {n} calls of sim -b 35 and -b 5 -B 20 "
          f"without a reach table bit-identical", flush=True)
    # the trip cap: a live lane still changing at the last trip is flagged
    # over; cut to 1-3 trips, some lanes end over by the cap alone
    for cap in (1, 2, 3):
        capped = 0
        for args in calls["sim -b 35"]:
            pb.I_PROJ = cap
            try:
                (_, over), _, _, e = pb_check(
                    args, f"a sim -b 35 call at a cap of {cap} trips")
            finally:
                pb.I_PROJ = 32
            err = max(err, e)
            _, over_full = pb.project_band_plain(*args)
            capped += int((over & ~over_full).sum())
        if capped < 1:
            fail(f"no lane ended over by a cap of {cap} trips")
        print(f"project_band vs plain at a cap of {cap} trips: all "
              f"{len(calls['sim -b 35'])} calls of sim -b 35 bit-identical, "
              f"{capped} lanes over by the cap alone", flush=True)

    main = max(calls["longsim x10 -b 35"], key=pb_slots)
    best, best_n = None, 0
    for cs in calls.values():
        for a in cs:
            _, over = pb.project_band(*a)
            k = int(over.sum()) if bool((a[5] & ~over).any()) else 0
            if k > best_n:
                best, best_n = a, k
    if best is None:
        fail("no recorded projection call had over lanes beside live ones")
    big = max(calls["biggraph -b 35"], key=pb_slots)
    ranks = big[8][big[0].clamp(0, big[8].shape[0] - 1)][big[0] < INT32_MAX]
    if int(ranks.max()) <= INT32_MAX // 1024:
        fail("the big-graph call's bands have no rank past 2,097,151")
    out = {}
    for key, args, what in (
            ("main", main, "the heaviest longsim x10 call"),
            ("over", best, f"the call with the most over lanes ({best_n}) "
                           "beside live ones"),
            ("big", big, "the heaviest big-graph call (ranks to "
                         f"{int(ranks.max()):,})")):
        out[key] = pb_timed(args, rate, card, what)
        err = max(err, out[key][0])
    _, ms, plain_ms, bms, by = out["main"]
    return (err, ms, plain_ms, bms, by), out["big"][1]


def run_cli_processes(tmp, argv, n, timeout=300):
    """``n`` port CLI processes of one torch.distributed group (gloo on a
    free local port), each on the card, each stopped before this returns.
    Returns the wall from the first start to the last exit."""
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    coord = f"localhost:{sock.getsockname()[1]}"
    sock.close()
    env = dict(os.environ, PYTHONPATH=ROOT, GA_NO_FALLBACK="1")
    procs = []
    t0 = time.time()
    try:
        for pid in range(n):
            work = os.path.join(tmp, f"p{pid}")
            os.makedirs(work, exist_ok=True)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "graphaligner_tpu_torch.runtime.cli",
                 *argv, "--backend", "cuda", "--coordinator", coord,
                 "--num-processes", str(n), "--process-id", str(pid)],
                cwd=work, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True,
            ))
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    for pid, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            fail(f"process {pid} of {n} exited {p.returncode}:\n{err[-3000:]}")
    return wall


def run_parallel_path(device, card, longsim, sim):
    """The port's parallel modes: longsim x10 -b 35 on a mesh of two shards
    on the one card, beside the same corpus unsharded; make_mesh() over
    every visible card on sim at both configs; and two --coordinator
    processes on the card, on sim -b 35 (strided) and ONT -b 5 -B 20
    (--shard components), their merged GAM against the golden and against
    one process's bytes. Every corpus byte for byte, 0 host lanes."""
    import torch

    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.core.params import AlignerParams
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import project_band as pb
    from graphaligner_tpu_torch.ops import walk_moves as k2
    from graphaligner_tpu_torch.parallel import make_mesh
    from graphaligner_tpu_torch.runtime.aligner import align_reads, stream, vg

    fb0 = ba.host_fallback_count()
    card0 = torch.device("cuda", torch.cuda.current_device())
    graph, reads, seeds, names = longsim
    golden = f"{FIX}/longsim/golden_b35.gam"
    two = make_mesh(devices=[card0, card0])
    # in turns: unsharded, mesh, mesh, unsharded; the counts over the
    # first mesh run
    walls = {"unsharded": [], "mesh": []}
    infos = {}
    for turn in ("unsharded", "mesh", "mesh", "unsharded"):
        first = turn == "mesh" and not walls["mesh"]
        if first:
            k1.LAUNCHES = k2.LAUNCHES = pb.LAUNCHES = 0
        results, wall, _, info = run_corpus(
            device, graph, reads, seeds, 35, 0,
            mesh=two if turn == "mesh" else None)
        walls[turn].append(wall)
        infos.setdefault(turn, info)
        if first:
            launches = (k1.LAUNCHES, k2.LAUNCHES, pb.LAUNCHES)
        if turn == "mesh":
            n_ok = check_golden("longsim x10 -b 35 on 2 shards", reads, names,
                                results, golden)
    if min(launches[:2]) < 1:
        fail(f"the mesh run launched K1/K2 {launches[:2]}")
    turns = [walls["unsharded"][0], *walls["mesh"], walls["unsharded"][1]]
    print(f"longsim x10 -b 35 on a [cuda:0, cuda:0] mesh: {n_ok}/{len(reads)}"
          f" aligned, byte-identical to the golden (both runs); reads/s in "
          f"turns (unsharded, mesh, mesh, unsharded): "
          f"{', '.join(f'{len(reads) / w:.1f}' for w in turns)} (walls "
          f"{', '.join(f'{w:.3f}' for w in turns)} s); launches K1 "
          f"{launches[0]}, K2 {launches[1]}, projection "
          f"{launches[2]}; a round's outputs at most "
          f"{', '.join(f'{b / 2**20:.0f}' for b in infos['mesh']['shard bytes'])}"
          f" MiB on each shard (unsharded: "
          f"{infos['unsharded']['shard bytes'][0] / 2**20:.0f} MiB), the "
          f"card's peak {infos['mesh']['peak'] / 2**20:.0f} MiB above the "
          f"aligner's set-up (unsharded: "
          f"{infos['unsharded']['peak'] / 2**20:.0f} MiB) [{card}]",
          flush=True)

    mesh = make_mesh()
    sgraph, sreads, sseeds, snames = sim
    for bw, ramp, gold in ((35, 0, "golden_b35"), (5, 20, "golden_b5_B20")):
        n1, n2 = k1.LAUNCHES, k2.LAUNCHES
        results, wall, _, _ = run_corpus(device, sgraph, sreads, sseeds, bw,
                                         ramp, mesh=mesh)
        name = f"sim -b {bw}" + (f" -B {ramp}" if ramp else "")
        n_ok = check_golden(f"{name} on make_mesh()", sreads, snames, results,
                            f"{FIX}/sim/{gold}/out.gam")
        if k1.LAUNCHES == n1 or k2.LAUNCHES == n2:
            fail(f"{name} on make_mesh() launched no K1 or no K2")
        print(f"{name} on make_mesh() ({mesh.size} card(s)): {n_ok}/"
              f"{len(sreads)} aligned, byte-identical to the golden; "
              f"{len(sreads) / wall:.1f} reads/s [{card}]", flush=True)

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    runs = (
        ("sim -b 35, 2 processes (--shard reads)", f"{FIX}/sim/bubbles.vg",
         f"{FIX}/sim/sim.fastq", f"{FIX}/sim/seeds.gam", 35, 0, "reads",
         f"{FIX}/sim/golden_b35/out.gam"),
        ("ONT -b 5 -B 20, 2 processes (--shard components)",
         f"{FIX}/longsim/graph.vg", f"{FIX}/ont/reads.fastq",
         f"{FIX}/ont/seeds.gam", 5, 20, "components",
         f"{FIX}/ont/golden_b5B20.gam"),
    )
    for name, g, f, sd, bw, ramp, mode, gold in runs:
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            merged = os.path.join(tmp, "merged.gam")
            argv = ["-g", g, "-f", f, "-s", sd, "-b", str(bw), "-a", merged]
            if ramp:
                argv += ["-B", str(ramp)]
            wall = run_cli_processes(tmp, argv + ["--shard", mode], 2)
            ords = [open(os.path.join(tmp, f"merged.shard{i}.gam.ord")).read()
                    .split() for i in range(2)]
            solo = os.path.join(tmp, "solo.gam")
            align_reads(AlignerParams(graph_file=g, fastq_file=f,
                                      alignment_file=solo, seed_file=sd,
                                      initial_bandwidth=bw,
                                      ramp_bandwidth=ramp),
                        log=lambda *a: None,
                        output_dir=os.path.join(tmp, "solo"))
            with open(merged, "rb") as a, open(solo, "rb") as b:
                if a.read() != b.read():
                    fail(f"{name}: the merged GAM differs from one "
                         "process's bytes")
            got = {a.name: a for a in stream.read_messages(merged,
                                                           vg.Alignment)}
            want = {a.name: a for a in stream.read_messages(gold,
                                                            vg.Alignment)}
            if got != want:
                fail(f"{name}: the merged GAM differs from the golden")
            print(f"{name}: {len(got)} alignments merged from shards of "
                  f"{len(ords[0])} and {len(ords[1])}, byte-identical to one "
                  f"process and equal to the golden; wall {wall:.2f} s (two "
                  f"processes from start to exit) [{card}]", flush=True)
    fallbacks = ba.host_fallback_count() - fb0
    if fallbacks:
        fail(f"{fallbacks} lanes fell back to the host oracle on the "
             "parallel path")
    return launches


def _messages(path):
    from graphaligner_tpu_torch.runtime.aligner import stream, vg

    return [a.encode() for a in stream.read_messages(path, vg.Alignment)]


def run_oracle_path(card):
    """``--backend oracle``, the per-read host path (no device), through
    align_reads on smallexample, sim -b 35 and sim -b 5 -B 20: the GAM and
    every per-read GAM and trace file the golden directory holds, byte for
    byte against the reference binary's goldens. Prints the wall a read on
    the host clock (align_reads's, graph loading included)."""
    from graphaligner_tpu_torch.core.params import AlignerParams
    from graphaligner_tpu_torch.runtime.aligner import align_reads, load_fastq

    sim = (f"{FIX}/sim/bubbles.vg", f"{FIX}/sim/sim.fastq",
           f"{FIX}/sim/seeds.gam")
    corpora = [
        ("smallexample -b 35", (f"{FIX}/smallexample/sub_test.vg",
                                f"{FIX}/smallexample/read.fastq",
                                f"{FIX}/smallexample/seedalignment.gam"),
         35, 0, f"{FIX}/golden/seeded.gam"),
        ("sim -b 35", sim, 35, 0, f"{FIX}/sim/golden_b35/out.gam"),
        ("sim -b 5 -B 20", sim, 5, 20, f"{FIX}/sim/golden_b5_B20/out.gam"),
    ]
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for i, (name, (g, f, s), bw, ramp, golden) in enumerate(corpora):
            work = os.path.join(tmp, str(i))
            params = AlignerParams(
                graph_file=g, fastq_file=f, seed_file=s,
                alignment_file=os.path.join(work, "out.gam"),
                initial_bandwidth=bw, ramp_bandwidth=ramp)
            t0 = time.perf_counter()
            alns = align_reads(params, log=lambda *a: None, output_dir=work,
                               backend="oracle")
            wall = time.perf_counter() - t0
            with open(params.alignment_file, "rb") as a, \
                    open(golden, "rb") as b:
                if a.read() != b.read():
                    fail(f"oracle {name}: the GAM differs from the golden")
            files = 0
            for read in load_fastq(f):
                for fn in (f"alignment_0_{read.seq_id}.gam",
                           f"trace_0_{read.seq_id}.trace"):
                    want = os.path.join(os.path.dirname(golden), fn)
                    if not os.path.exists(want):
                        continue
                    with open(os.path.join(work, fn), "rb") as a, \
                            open(want, "rb") as b:
                        if a.read() != b.read():
                            fail(f"oracle {name}: {fn} differs from the "
                                 "golden")
                    files += 1
            n = len(load_fastq(f))
            print(f"oracle {name}: {len(alns)}/{n} aligned on the host, the "
                  f"GAM and {files} per-read files byte-identical to the "
                  f"reference goldens; {wall:.3f} s, {wall / n:.4f} s a read "
                  f"on the host clock, graph loading included [{card}]",
                  flush=True)


def run_limit_path(device, card):
    """A named limit of the device path: multiallelic_small (in-degree 8)
    at -b 35 on ``device`` with LONG_WINDOW 4, so that the batched path
    runs its wide K1 in long mode and raises NotImplementedError where the
    long walk would start (it takes in-degree <= 4). The error reaches the
    caller, its message naming --backend oracle, with GA_NO_FALLBACK unset
    (for this phase only) and set alike: no read is realigned on the host
    and no GAM is written. Returns the first run's launches, counted apart
    from every other phase's."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.core.params import AlignerParams
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import project_band as pb
    from graphaligner_tpu_torch.ops import walk_moves as k2
    from graphaligner_tpu_torch.runtime import aligner

    d = f"{FIX}/torch/multiallelic_small"
    saved_env = os.environ.pop("GA_NO_FALLBACK", None)
    saved_window = ba.BandedBatchAligner.LONG_WINDOW
    ba.BandedBatchAligner.LONG_WINDOW = 4
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    raised = {}
    try:
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            for no_fallback in (None, "1"):
                if no_fallback:
                    os.environ["GA_NO_FALLBACK"] = no_fallback
                work = os.path.join(tmp, str(no_fallback))
                params = AlignerParams(
                    graph_file=f"{d}/graph.gfa",
                    fastq_file=f"{d}/reads.fastq",
                    seed_file=f"{d}/seeds.gam",
                    alignment_file=os.path.join(work, "out.gam"),
                    initial_bandwidth=35)
                k1.LAUNCHES = k1.LAUNCHES_WIDE = k2.LAUNCHES = 0
                k2.LAUNCHES_WIDE = pb.LAUNCHES = 0
                t0 = time.perf_counter()
                try:
                    aligner.align_reads(params, log=lambda *a: None,
                                        output_dir=work, backend=device)
                except NotImplementedError as e:
                    raised[no_fallback] = (str(e), time.perf_counter() - t0)
                else:
                    fail(f"limit: the run went through (GA_NO_FALLBACK="
                         f"{no_fallback})")
                if no_fallback is None:
                    launches = {"slice_cells": k1.LAUNCHES,
                                "slice_cells_wide": k1.LAUNCHES_WIDE,
                                "walk_moves": k2.LAUNCHES,
                                "walk_moves_wide": k2.LAUNCHES_WIDE,
                                "project_band": pb.LAUNCHES}
                msg = raised[no_fallback][0]
                if "in-degree <= 4" not in msg \
                        or "--backend oracle" not in msg:
                    fail(f"limit: the error does not name the limit and "
                         f"--backend oracle: {msg}")
                if os.path.exists(params.alignment_file) or (
                        os.path.isdir(work) and any(
                            n.startswith("alignment_0_")
                            for n in os.listdir(work))):
                    fail("limit: the run that raised wrote alignments")
            if launches["slice_cells_wide"] < 1:
                fail(f"limit: the wide K1 never launched before the raise: "
                     f"{launches}")
    finally:
        ba.BandedBatchAligner.LONG_WINDOW = saved_window
        if saved_env is None:
            os.environ.pop("GA_NO_FALLBACK", None)
        else:
            os.environ["GA_NO_FALLBACK"] = saved_env
    print(f"limit, multiallelic_small -b 35 at LONG_WINDOW 4 on {device}: "
          f"the batched path raised after {launches['slice_cells_wide']} "
          f"wide K1 launches ({launches}) in {raised[None][1]:.3f} s, with "
          f"GA_NO_FALLBACK unset and set alike, nothing realigned or "
          f"written [{card}]: {raised[None][0]}", flush=True)
    return launches


def run_tools_path(device, card):
    """The tools around the aligner (tests/test_tools.py:169 at a larger
    size): simulate_reads draws 50 reads of 300 bp from sim/bubbles.vg with
    seeds, the CLI aligns them on ``device``, and compare_alignments scores
    the device's GAM against the truth; every forward-strand read must
    reach identity 0.7, as the test asks. The CLI with --backend oracle
    aligns the first ORACLE_READS of them (the scalar oracle takes about
    0.1 s a read), each message byte for byte the device's. Prints the
    counts."""
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import walk_moves as k2
    from graphaligner_tpu_torch.runtime import cli
    from graphaligner_tpu_torch.runtime.aligner import stream, vg
    from graphaligner_tpu_torch.tools import compare_alignments, simulate_reads

    graph = f"{FIX}/sim/bubbles.vg"
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        truth, reads, seeds = (os.path.join(tmp, n) for n in
                               ("truth.gam", "reads.fastq", "seeds.gam"))
        simulate_reads.main([graph, truth, reads, "50", "300", "0.02", "0.02",
                             seeds, "0.02", "7"])
        subset = os.path.join(tmp, "subset.fastq")
        with open(reads) as src, open(subset, "w") as dst:
            dst.writelines(src.readlines()[:4 * ORACLE_READS])
        outs = {}
        k1.LAUNCHES = k2.LAUNCHES = 0
        for backend, fastq in ((device, reads), ("oracle", subset)):
            work = os.path.join(tmp, backend)
            os.makedirs(work)
            os.chdir(work)  # the CLI writes its per-read files here
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = cli.main(["-g", graph, "-f", fastq, "-s", seeds,
                                   "-b", "35", "-a", "out.gam",
                                   "--backend", backend])
                outs[backend] = (os.path.join(work, "out.gam"),
                                 time.perf_counter() - t0)
            finally:
                os.chdir(cwd)
            if rc != 0:
                fail(f"tools: the CLI exited {rc} on {backend}")
            if backend == device:
                launches = (k1.LAUNCHES, k2.LAUNCHES)
        if min(launches) < 1:
            fail(f"tools: K1 or K2 never launched on {device}: {launches}")
        on_device = {a.name: a.encode() for a in stream.read_messages(
            outs[device][0], vg.Alignment)}
        host = stream.read_messages(outs["oracle"][0], vg.Alignment)
        if len(host) != ORACLE_READS or any(
                on_device.get(a.name) != a.encode() for a in host):
            fail(f"tools: the {device} GAM differs from the oracle's on its "
                 f"first {ORACLE_READS} reads")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            compare_alignments.main([truth, outs[device][0], graph])
        # its last two lines: "good matches: N", "bad matches: M"
        good, bad = (int(line.split(": ")[1])
                     for line in printed.getvalue().splitlines()[-2:])
        truths = stream.read_messages(truth, vg.Alignment)
        pred = {a.name: a for a in stream.read_messages(outs[device][0],
                                                        vg.Alignment)}
        sizes = compare_alignments.node_sizes(
            compare_alignments.load_vg_graph(graph))
        forward = [t for t in truths
                   if not t.path.mapping[0].position.is_reverse]
        low = [t.name for t in forward if t.name not in pred
               or compare_alignments.identity_percent(
                   compare_alignments.alignment_identity(
                       t, pred[t.name], sizes)) < 0.7]
        if not forward or low:
            fail(f"tools: forward-strand reads under identity 0.7: {low}")
    print(f"tools: simulate_reads 50 x 300 bp -> CLI on {device} "
          f"({outs[device][1]:.3f} s, K1 {launches[0]}, K2 {launches[1]} "
          f"launches; its first {ORACLE_READS} reads byte-identical to "
          f"--backend oracle's, {outs['oracle'][1]:.3f} s for those) -> "
          f"compare_alignments: "
          f"{len(pred)} aligned, good matches {good}, bad matches {bad}; all {len(forward)} forward-strand"
          f" reads at identity >= 0.7 [{card}]", flush=True)


def main() -> int:
    t_start = time.time()
    if not os.path.isdir(os.path.join(ROOT, "graphaligner_tpu_torch")):
        fail("graphaligner_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
    os.environ["GA_NO_FALLBACK"] = "1"
    t_phase = [t_start]

    def stamp(phase):
        """Splits the smoke's wall: each phase's share on the host clock."""
        now = time.time()
        print(f"[phase] {phase}: {now - t_phase[0]:.1f} s, {now - t_start:.0f}"
              " s into the smoke", flush=True)
        t_phase[0] = now

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
          flush=True)

    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.io import load_fastq, native
    from graphaligner_tpu_torch.ops import _build
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import exhaustive as k3
    from graphaligner_tpu_torch.ops import walk_moves as k2

    t0 = time.time()
    kernels_built = ("banded_cell", "walk_moves", "exhaustive",
                     "project_band")
    with ThreadPoolExecutor(len(kernels_built) + 1) as pool:
        jobs = [pool.submit(_build.library, n) for n in kernels_built]
        jobs.append(pool.submit(native.build_library))
        for job in jobs:
            job.result()
    native.get_lib()
    print(f"built {', '.join(f'csrc/{n}.cu' for n in kernels_built)} with "
          f"nvcc {' '.join(_build.NVCC_FLAGS)} (in parallel) and the native "
          f"library with g++ in {time.time() - t0:.1f} s", flush=True)
    rate = int32_rate()
    print(f"int32 issue rate {rate / 1e12:.3f} Tops/s (SMs x "
          f"{INT32_LANES_PER_SM} lanes x max SM clock) [{card}]", flush=True)
    for name, (secs, log) in _build.BUILD_LOG.items():
        for line in log.strip().splitlines():
            print(f"  [{name}] {line}", flush=True)
    stamp("start-up and kernel builds")

    sim = load_corpus(f"{FIX}/sim/bubbles.vg", f"{FIX}/sim/sim.fastq",
                      f"{FIX}/sim/seeds.gam")
    longsim = load_corpus(f"{FIX}/longsim/graph.vg",
                          f"{FIX}/longsim/reads.fastq",
                          f"{FIX}/longsim/seeds.gam", tile=TILE)
    ont = load_corpus(f"{FIX}/longsim/graph.vg", f"{FIX}/ont/reads.fastq",
                      f"{FIX}/ont/seeds.gam")
    # warm-up (CUDA context, allocator, library loads) outside the count
    run_corpus(device, sim[0], sim[1][:4], sim[2], 35, 0)

    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    fb0 = ba.host_fallback_count()
    rec = Recorder()
    corpora = [
        ("longsim x10 -b 35", longsim, 35, 0, f"{FIX}/longsim/golden_b35.gam"),
        ("sim -b 35", sim, 35, 0, f"{FIX}/sim/golden_b35/out.gam"),
        ("sim -b 5 -B 20", sim, 5, 20, f"{FIX}/sim/golden_b5_B20/out.gam"),
        ("ont -b 35", ont, 35, 0, f"{FIX}/ont/golden_b35.gam"),
        ("ont -b 5 -B 20", ont, 5, 20, f"{FIX}/ont/golden_b5B20.gam"),
    ]
    try:
        for name, (graph, reads, seeds, names), bw, ramp, golden in corpora:
            # ONT's K2 calls take longsim's shapes: the plain walk, slow at
            # K=160, is held against the kernel on longsim's and sim's
            rec.on = not name.startswith("ont")
            results, wall, cells, info = run_corpus(device, graph, reads,
                                                    seeds, bw, ramp)
            n_ok = check_golden(name, reads, names, results, golden)
            bp = sum(len(r.sequence) for r in reads)
            print(f"{name}: {n_ok}/{len(reads)} aligned, byte-identical to the "
                  f"golden; {len(reads) / wall:.1f} reads/s, "
                  f"{cells / wall / 1e6:.1f} Mcells/s, {bp / 1e6:.2f} Mbp in "
                  f"{wall:.2f} s, peak device memory {info['peak'] / 2**20:.0f}"
                  f" MiB above what the aligner's set-up holds [{card}]",
                  flush=True)
    finally:
        rec.close()
    launches = {"slice_cells": k1.LAUNCHES, "walk_moves": k2.LAUNCHES}
    fallbacks = ba.host_fallback_count() - fb0
    print(f"main-path launches: K1 slice_cells {launches['slice_cells']}, "
          f"K2 walk_moves {launches['walk_moves']}; host-fallback lanes "
          f"{fallbacks}", flush=True)
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    if fallbacks:
        fail(f"{fallbacks} lanes fell back to the host oracle")
    if rec.k1 is None or not rec.k2:
        fail("kernel arguments were not recorded")
    stamp("seeded corpora")
    long_launches, lrec = run_long_path(device, card, ont)
    stamp("long-read path")
    nr_launches, pb_calls, big = run_no_reach_path(device, card, longsim,
                                                   sim, ont)
    stamp("no-reach path and the big graph")
    for name in ("slice_cells", "walk_moves"):
        launches[name] += long_launches[name] + nr_launches[name]
    launches["project_band"] = nr_launches["project_band"]
    wide_launches, wrec, ma = run_wide_path(device, card)
    stamp("wide path (multiallelic)")
    for name in ("slice_cells_wide", "walk_moves_wide"):
        launches[name] = wide_launches[name]
    cv_launches, cvrec, cv_pb, cv, cv_walls = run_converging_path(device,
                                                                  card)
    stamp("converging path")
    for name in ("slice_cells_wide", "walk_moves_wide", "project_band"):
        launches[name] += cv_launches[name]

    # exhaustive mode (-i): K3's two routes, through align_reads
    k3.LAUNCHES_WAVEFRONT = 0
    k3.LAUNCHES_SERIAL = 0
    fb0 = ba.host_fallback_count()
    rec3 = K3Recorder()
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        sim_reads = f"{FIX}/sim/sim.fastq"
        tiled = os.path.join(tmp, f"sim_x{TILE_I}.fastq")
        tiled_names = write_tiled_fastq(sim_reads, tiled, TILE_I)
        corpora_i = [
            ("smallexample -i", f"{FIX}/smallexample/sub_test.vg",
             f"{FIX}/smallexample/read.fastq", "smallexample_i"),
            ("sim -i", f"{FIX}/sim/bubbles.vg", sim_reads, "sim_i"),
            (f"longsim x{TILE_I} -i", f"{FIX}/longsim/graph.vg", tiled,
             "longsim_i"),
            ("cyclic -i", f"{FIX}/sim/cyclic.gfa",
             f"{FIX}/torch/cyclic_i/reads.fastq", "cyclic_i"),
            ("circular -i", f"{FIX}/torch/circular_i/graph.gfa",
             f"{FIX}/torch/circular_i/reads.fastq", "circular_i"),
        ]
        try:
            for name, graph_file, reads_file, golden in corpora_i:
                names = tiled_names if reads_file == tiled else {
                    r.seq_id: r.seq_id for r in load_fastq(reads_file)
                }
                rec3.corpus = name
                torch.cuda.reset_peak_memory_stats(device)
                alns, wall = run_exhaustive(graph_file, reads_file,
                                            os.path.join(tmp, golden))
                n_ok = check_golden_i(
                    name, names, alns,
                    f"{FIX}/torch/{golden}/out.gam",
                )
                peak = torch.cuda.max_memory_allocated(device)
                k3_ms = [c[3] for c in rec3.calls if c[0] == name]
                split = rec3.split[name]
                print(f"{name}: {n_ok}/{len(names)} aligned, every read "
                      f"byte-identical to the JAX golden; {len(names) / wall:.2f}"
                      f" reads/s ({wall:.3f} s: set-up {split['setup']:.3f} s, "
                      f"compute_tables {split['tables']:.3f} s, the rest "
                      f"{wall - split['setup'] - split['tables']:.3f} s), K3 "
                      f"{len(k3_ms)} launch(es) of "
                      f"{', '.join(f'{t:.3f}' for t in k3_ms)} ms, peak device "
                      f"memory {peak / 2**20:.0f} MiB [{card}]", flush=True)
        finally:
            rec3.close()
    launches["exhaustive_wavefront"] = k3.LAUNCHES_WAVEFRONT
    launches["exhaustive_serial"] = k3.LAUNCHES_SERIAL
    fallbacks = ba.host_fallback_count() - fb0
    print(f"-i launches: K3 wavefront {launches['exhaustive_wavefront']}, "
          f"K3 cyclic {launches['exhaustive_serial']}; host-fallback lanes "
          f"{fallbacks}", flush=True)
    if min(launches["exhaustive_wavefront"], launches["exhaustive_serial"]) < 1:
        fail("a K3 route never launched on the -i path")
    if fallbacks:
        fail(f"{fallbacks} lanes fell back to the host oracle")
    stamp("exhaustive -i")

    mesh_launches = run_parallel_path(device, card, longsim, sim)
    print(f"parallel path, longsim x10 on 2 shards: K1 {mesh_launches[0]}, "
          f"K2 {mesh_launches[1]}, projection {mesh_launches[2]} launches",
          flush=True)
    stamp("parallel path")

    # the per-read host path, a named limit and the tools; their launches
    # are counted apart from the kernels line's
    run_oracle_path(card)
    stamp("per-read host path")
    run_limit_path("cuda", card)
    stamp("limit")
    run_tools_path("cuda", card)
    stamp("tools")

    check_redispatch(lrec)
    k2_long_err = compare_k2_long(lrec, card)
    if lrec.k1 is None:
        fail("no long-mode K1 call of huge's widest tier was recorded")
    k1_long_err = compare_k1(lrec.k1, rate, "the last call of huge's widest "
                             "long-mode tier")[0]
    stamp("long-mode checks against the plain versions")
    results = {
        "slice_cells": compare_k1(rec.k1, rate, "its widest longsim call"),
        "walk_moves": compare_k2(rec, rate),
        "exhaustive_wavefront": compare_k3(rec3, rate),
        "exhaustive_serial": compare_k3_cyclic(rec3, rate, card),
    }
    stamp("K1, K2, K3 against the plain versions")
    results["slice_cells_wide"] = compare_k1(
        wrec.k1, rate, "the wide route's widest multiallelic call (K_in 8)")
    results["walk_moves_wide"] = compare_k2(wrec, rate, "walk_moves (wide)")
    results["project_band"], big_ms = compare_pb(pb_calls, rate, card)
    stamp("wide K1, wide K2 and the projection against the plain versions")
    del pb_calls
    # the converging phase (in-degree 80): one recorded call of each
    cv_k_in = cvrec.k1[0][14].shape[1]
    if sorted(cvrec.k1_tiers) != [288, 576, 1152]:
        fail(f"converging's K1 calls came at tiers {sorted(cvrec.k1_tiers)}"
             ", not at Cm 288, 576 and 1152")
    cv_errs = [
        max(compare_k1(call, rate, f"the converging phase's widest call at "
                       f"Cm={Cm} (K_in {cv_k_in})")[0]
            for Cm, call in sorted(cvrec.k1_tiers.items())),
        compare_k2(SimpleNamespace(k2=[max(cvrec.k2,
                                           key=lambda r: r[0][0].numel())]),
                   rate, f"walk_moves (wide, K_in {cv_k_in})")[0],
        pb_timed(max(cv_pb, key=pb_slots), rate, card, "the converging "
                 "phase's heaviest call (K_out "
                 f"{cv_pb[0][6].shape[1]})")[0],
    ]
    del cvrec, cv_pb
    stamp("the converging calls against the plain versions")
    for name, e in zip(("slice_cells_wide", "walk_moves_wide",
                        "project_band"), cv_errs):
        err, *rest = results[name]
        results[name] = (max(err, e), *rest)
    print(f"biggraph -b 35: projection {big_ms:.4f} ms a slice at its "
          f"heaviest call, {big[0]} launches (two a slice) over {big[1]} "
          f"slices [{card}]",
          flush=True)
    k2_window_chain(rec)
    k2_top_tier(rec)
    stamp("K2 window chain and top tier")
    profile_seeded(device, longsim, card)
    profile_seeded(device, ma, card, name="multiallelic x10")
    profile_seeded(device, cv, card, "no reach table",
                   name=f"converging x{len(cv[1]) // len(set(cv[3].values()))}",
                   walls=cv_walls)
    os.environ["GA_REACH_MAXN"] = "0"
    try:
        profile_seeded(device, longsim, card, "GA_REACH_MAXN=0")
    finally:
        del os.environ["GA_REACH_MAXN"]
    stamp("profiles")
    pallas = "graphaligner_tpu/ops/pallas"
    sources = {
        "slice_cells": ("banded_cell.cu", f"{pallas}/banded_cell.py:44"),
        "walk_moves": ("walk_moves.cu", f"{pallas}/walk_moves.py:135"),
        # XLA code in the JAX package past 5 (K1) and 4 (K2) in-neighbours
        "slice_cells_wide": ("banded_cell.cu",
                             "graphaligner_tpu/core/engine_banded.py:883"),
        "walk_moves_wide": ("walk_moves.cu",
                            "graphaligner_tpu/core/backtrace_device.py:50"),
        "exhaustive_wavefront": ("exhaustive.cu", f"{pallas}/exhaustive.py:60"),
        "exhaustive_serial": ("exhaustive.cu", f"{pallas}/exhaustive.py:60"),
        # XLA code in the JAX package (the pairwise projection)
        "project_band": ("project_band.cu",
                         "graphaligner_tpu/core/engine_banded.py:445"),
    }
    err, *rest = results["walk_moves"]
    results["walk_moves"] = (max(err, k2_long_err), *rest)
    err, *rest = results["slice_cells"]
    results["slice_cells"] = (max(err, k1_long_err), *rest)
    kernels = []
    for name, (err, ms, plain_ms, bound_ms, by) in results.items():
        src, tpu = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"graphaligner_tpu_torch/csrc/{src}",
            "replaces": tpu,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None,
        })
    print(f"smoke wall {time.time() - t_start:.0f} s (kernel builds "
          "included)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
