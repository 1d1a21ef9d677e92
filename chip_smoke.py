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
  each corpus's wall split (from batch_align.LONG_STATS) into set-up, scan
  rounds, their replay, the walk's recompute and K2 windows, and the rest,
  with the windows a lane and the peak device memory above what the
  aligner's set-up holds; giant again in one normal-mode scan
  (LONG_WINDOW 640) and in rounds of 96, for their peaks; and huge's 4
  reads, which must raise under GA_NO_FALLBACK=1 (2 of them pass 32 band
  nodes at every capacity tier);
- exhaustive mode, -i, through ``align_reads``: K3's slice wavefront on
  the acyclic graphs — smallexample, sim (20 reads on bubbles.vg) and the
  longsim graph x the sim reads tiled x8 (160 lanes) — and K3's cyclic
  route on sim/cyclic.gfa x 32 reads through its repeat and on the longsim
  graph closed into a circle x 16 reads of 640 bp, half across the seam,
  every read byte for byte against the JAX-made goldens of
  tests/fixtures/torch/.

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
and on its first 128 lanes padded to Cm=2304; K3's wavefront six slabs bit
for bit on its sim call, and K3's cyclic route on sim/cyclic.gfa at pass
caps 1, 2 and 128 (one pass must flag every lane, 128 none), with its
passes and recomputed nodes per pass there and on the circle.
Each kernel's bound (the larger of its bytes over the memory rate and its
integer operations over the card's int32 issue rate) is computed from the
recorded arguments, K2's from the walk that ran, the cyclic route's on
sim/cyclic.gfa from the positions the plain version's passes show the
fixpoint needs. One more longsim x10 run
under torch.profiler gives the device-kernel count, busy time and idle
share of the seeded path, and K2's launches and summed time there.

Prints the card's name and power limit, versions, build time, per-corpus
rates, one JSON line of kernel results, and last
{"ok": true, "device": {...}}. Exits non-zero on any failure, and at once
when CUDA is unavailable or the repository is not beside this script.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")
INT32_MAX = 2**31 - 1
TILE = 10
TILE_I = 8  # -i at the repo's scale: longsim graph x sim reads x8
# huge's reads whose forward pieces project more than 32 band nodes at every
# capacity tier (K1 packs 32 node slots; the graph has 8-bp nodes), at
# slices 564 and 211: the JAX package sends them to its host oracle too
HUGE_OVER_NM = ("read_1635367824", "read_604779437")

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
# a node start merging its in-neighbours costs one pred advance and merge
# per in-neighbour, as K1 counts it (K1_OPS_PRED), whatever way the kernel
# merges


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def load_corpus(graph_file, reads_file, seeds_file, tile=1):
    from graphaligner_tpu_torch.runtime.aligner import (
        load_alignment_graph,
        load_fastq,
        load_seed_hits,
    )

    graph = load_alignment_graph(graph_file)
    base = load_fastq(reads_file)
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
               aligner_cls=None):
    """(results, wall, cells, info) of one seeded run through
    align_reads_seeded_batch: info holds the aligner's set-up seconds (graph
    tables, reach table), its first tier's Cm, and the run's peak device
    memory above what is held once the aligner is built ("peak")."""
    import torch

    from graphaligner_tpu_torch.core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
    )

    torch.cuda.synchronize(device)
    t0 = time.time()
    aligner = (aligner_cls or BandedBatchAligner)(graph, bw, ramp, device)
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
            "peak": torch.cuda.max_memory_allocated(device) - held}
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
        # [args, kwargs, outputs of the run, decode args, decoded traces]
        self.k2 = []
        self.on = True  # record (off for corpora whose calls repeat shapes)
        self._mods = (eb, ba, native)
        self._orig = (eb.slice_cells, ba.walk_moves, native.decode_moves_batch)

        def rec_k1(*args, **kw):
            if self.on and (self.k1 is None
                            or args[0].shape[1] > self.k1[0][0].shape[1]):
                self.k1 = ([a.clone() for a in args], kw)
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
    print(f"K1 slice_cells (fused) vs plain on {what} at Cm={Cm} Nm={Nm} "
          f"B={B}: eight outputs bit-identical; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms; bound {bms:.5f} ms by {by} ({moved} B, {ops} "
          f"int32 ops), share {bms / ms:.4f}", flush=True)
    return err, ms, plain_ms, bms, by


def k2_work(args, outs, decode, traces):
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
    K2_OPS_SLOT a band slot of each walked slice."""
    import numpy as np

    Nm = args[1].shape[1]
    used = outs[3][0].cpu().numpy().astype(np.int64)
    sk_in = args[10][0].cpu().numpy().astype(np.int64)
    sk_out = outs[2][0].cpu().numpy().astype(np.int64)
    walked = np.where(used > 0, sk_in - sk_out + 1, 0)
    ops = int(used.sum()) * K2_OPS_STEP + int(walked.sum()) * Nm * K2_OPS_SLOT
    moved = 4 * 19 * len(used) + 4 * int((used // 8 + 1 + 18).sum())
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


def k2_lanes(args, n):
    """A K2 call's first n lanes (every argument is lane-last but
    bits_lut)."""
    return [a if i == 6 else a[..., :n].contiguous()
            for i, a in enumerate(args)]


def k2_decode(moves, used, decode):
    """The native decode of a K2 call's moves, as core.batch_align runs
    it: (w, r, n) slabs of the recorded decode call's lanes."""
    import numpy as np

    from graphaligner_tpu_torch.core.batch_align import native

    dargs, dkw = decode
    rows = min(moves.shape[0], int(used.max()) // 8 + 1)
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


def compare_k2(rec, rate):
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
        n_lanes += got[1].shape[1]
        if decode is not None:
            k2_traces_equal(k2_decode(want[0], want[3], decode), traces,
                            "between the plain walk and the main run")
            n_traces += len(traces[2])
    args, kw, outs, decode, traces = largest
    if decode is None:
        fail("no lane of the widest K2 call was decoded")
    K1_, _, Cm, B = args[0].shape
    Nm, R = args[1].shape[1], args[6].shape[0]
    smem = k2.smem_bytes(Cm, Nm, R)
    ms = cuda_ms(lambda: k2.walk_moves(*args, **kw), 3)
    moved, ops = k2_work(args, outs, decode, traces)
    bms, by = bound(moved, ops, rate)
    steps = int(outs[3].max())
    print(f"K2 walk_moves vs walk_moves_plain(Bb=1) over {len(rec.k2)} "
          f"calls: moves, fail, state_out and used bit-identical on all "
          f"{n_lanes} lanes (max abs err {err}); the plain walk's moves decode "
          f"to the main run's {n_traces} traces; "
          f"one lane a block, one slice buffer, {smem} B shared; at "
          f"K={K1_ - 1} Cm={Cm} B={B} kernel {ms:.3f} ms ({steps} steps in "
          f"the longest lane, {ms * 1e6 / steps:.1f} ns a step), plain "
          f"{plain_ms:.1f} ms; bound {bms:.5f} ms by {by} ({moved} B, {ops} "
          f"int32 ops), share {bms / ms:.4f}", flush=True)
    n = min(256, B)
    sub = k2_lanes(args, n)
    ms_sub = cuda_ms(lambda: k2.walk_moves(*sub, **kw), 5)
    (lanes, *rest), dkw = decode
    keep = lanes < n
    sub_decode = ((lanes[keep], *[x[keep] for x in rest[:2]], *rest[2:]), dkw)
    m_sub, o_sub = k2_work(sub, k2_lanes(outs, n), sub_decode,
                           tuple(x[keep] for x in traces))
    b_sub, by_sub = bound(m_sub, o_sub, rate)
    print(f"K2 at {n} of those lanes: kernel {ms_sub:.3f} ms; bound "
          f"{b_sub:.5f} ms by {by_sub} ({m_sub} B, {o_sub} int32 ops), share "
          f"{b_sub / ms_sub:.4f}", flush=True)
    for line in _build.BUILD_LOG.get("walk_moves", (0, ""))[1].splitlines():
        if "registers" in line or "stack" in line or "spill" in line:
            print(f"  [walk_moves ptxas] {line.strip()}", flush=True)
    return err, ms, plain_ms, bms, by


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
    to 2304, the top of the capacity ladder: bit for bit against
    walk_moves_plain(Bb=1) and the unpadded call's outputs; timed."""
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
    k2_equal(got, k2.walk_moves_plain(*top, **kw, Bb=1),
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


def profile_seeded(device, corpus, card):
    """longsim x10 once more unprofiled (its wall) and once under
    torch.profiler: device kernels (and copies) counted, their summed
    device time (one stream, so the busy time), the idle share of the
    unprofiled wall, and the fused K1's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphaligner_tpu_torch.ops import banded_cell as k1

    graph, reads, seeds, _ = corpus
    _, wall, _, _ = run_corpus(device, graph, reads, seeds, 35, 0)
    n1 = k1.LAUNCHES
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_corpus(device, graph, reads, seeds, 35, 0)
    wall_prof = time.time() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        print("profiled longsim x10: torch.profiler recorded no device "
              "events (device time not measured)", flush=True)
        return
    busy = sum(dev_us(e) for e in events) / 1e6
    k1_events = sum(1 for e in events if "slice_cells" in e.name)
    slices = k1.LAUNCHES - n1
    print(f"profiled longsim x10 -b 35: {len(events)} device kernels and "
          f"copies ({len(events) / max(slices, 1):.1f} a slice over {slices} "
          f"fused K1 launches, {k1_events} seen by the profiler), device busy "
          f"{busy:.3f} s; unprofiled wall {wall:.3f} s, idle share "
          f"{1 - busy / wall:.3f} (profiled wall {wall_prof:.3f} s) [{card}]",
          flush=True)
    k2_events = [e for e in events if "walk_moves" in e.name]
    print(f"  K2 walk_moves_kernel: {len(k2_events)} launches, "
          f"{sum(dev_us(e) for e in k2_events) / 1e3:.3f} ms summed device "
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
        ba.LONG_STATS.clear()
        rw0 = ba.rewind_count()
        results, wall, cells, info = run_corpus(device, graph, reads, seeds,
                                                bw, ramp, window)
        n_ok = check_golden(name, reads, names, results, golden)
        st = dict(ba.LONG_STATS)
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


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "graphaligner_tpu_torch")):
        fail("graphaligner_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
    os.environ["GA_NO_FALLBACK"] = "1"
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
    kernels_built = ("banded_cell", "walk_moves", "exhaustive")
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
    long_launches, lrec = run_long_path(device, card, ont)
    for name in ("slice_cells", "walk_moves"):
        launches[name] += long_launches[name]

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

    check_redispatch(lrec)
    k2_long_err = compare_k2_long(lrec, card)
    if lrec.k1 is None:
        fail("no long-mode K1 call of huge's widest tier was recorded")
    k1_long_err = compare_k1(lrec.k1, rate, "the last call of huge's widest "
                             "long-mode tier")[0]
    results = {
        "slice_cells": compare_k1(rec.k1, rate, "its widest longsim call"),
        "walk_moves": compare_k2(rec, rate),
        "exhaustive_wavefront": compare_k3(rec3, rate),
        "exhaustive_serial": compare_k3_cyclic(rec3, rate, card),
    }
    k2_window_chain(rec)
    k2_top_tier(rec)
    profile_seeded(device, longsim, card)
    sources = {
        "slice_cells": ("banded_cell.cu", "banded_cell.py:44"),
        "walk_moves": ("walk_moves.cu", "walk_moves.py:135"),
        "exhaustive_wavefront": ("exhaustive.cu", "exhaustive.py:60"),
        "exhaustive_serial": ("exhaustive.cu", "exhaustive.py:60"),
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
            "replaces": f"graphaligner_tpu/ops/pallas/{tpu}",
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
