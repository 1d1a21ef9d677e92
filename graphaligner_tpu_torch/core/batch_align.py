"""Batched seeded alignment: device DP rounds + exact host control replay.

Port of ``graphaligner_tpu/core/batch_align.py``. The reference's
getSqrtSlices control loop (GraphAligner.h:2571-2856) is split as there:

  device: every round is one ``banded_scan`` over all lanes (problems
          packed back to back into segmented lanes, first-fit decreasing),
          recording per-slice minima, band tables and packed columns;
  host:   the control flow (float64 correctness HMM, bandwidth-ramping
          rewinds) is replayed exactly against the recorded minima; lanes
          that rewind go into the next round, restarted from the recorded
          carry.

The walk starts are decided on the device (unique minima and same-node
ties) or by the native band-order replay (multi-node ties); the backtrace
runs as kernel K2 (``ops.walk_moves``) and the native decoder turns its
move codes back into traces. Lanes that overflow a capacity tier retry on
the 2x tier; what still fails falls back to the host oracle per lane
(``GA_NO_FALLBACK=1`` makes that an error; each use is counted).

Reads longer than the window run in the memory-bounded long-read mode: chained
scan rounds of one window each, whose packed columns are dropped once the
replay no longer needs them; the walk recomputes them a round at a time,
newest first, and chains K2 across the windows (``_walk_long``).

Device tensors stay on ``device``; the host reads them with ``.cpu()``.
Not ported (each raises NotImplementedError): the XLA walk for in-degree
> 4, and the pairwise projection for graphs without a reach table.
"""

from __future__ import annotations

import os as _os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..graph.alignment_graph import AlignmentGraph
from ..io import native
from ..ops import banded_cell as _k1
from ..ops import walk_moves as _k2
from ..ops.walk_moves import max_window_slices, moves_walk_fits, walk_moves
from . import hmm as _hmm
from .align import _pad_to_word
from .engine import _ENCODE_LUT, _READ_CODE
from .engine_banded import banded_scan
from .hmm import CorrectnessState
from .params import (
    ALTERNATE_METHOD_CUTOFF,
    BACKTRACE_OVERRIDE_CUTOFF,
    WORD_SIZE,
)
from .reach import ensure_reach
from .tables import (
    EMPTY,
    INF,
    build_graph_tables,
    device_tables,
)

# bandwidth-ramp rewinds taken by the host replay
_REWIND_COUNT = 0
# lanes that fell back to the host oracle (process-wide count)
_HOST_FALLBACKS = 0
_HOST_THREADS = 0
# the long-read mode's work since a caller last cleared this: host seconds
# of the scan rounds ("scan rounds"), their control replay ("replay") and
# the whole walk ("walk"); seconds of the walk's recomputes ("recompute")
# and K2 windows ("K2 windows"), from CUDA events read once the walk has
# synchronized (the host clock on the CPU); the kernels' launches in the
# scan rounds ("k1 rounds"), the recomputes ("k1 recompute") and the
# windows ("k2"); the lanes walked ("lanes") and lane-windows ("lane
# windows"); and on the card the allocator's peak since the caller last
# reset it, read as the scan rounds end ("peak scan") and as the walk ends
# ("peak walk")
LONG_STATS: dict = {}


def _long_add(key, value) -> None:
    LONG_STATS[key] = LONG_STATS.get(key, 0) + value


def _long_peak(key, dev) -> None:
    if dev.type == "cuda":
        LONG_STATS[key] = max(LONG_STATS.get(key, 0),
                              torch.cuda.max_memory_allocated(dev))


def _mark(dev):
    """A point in time on ``dev``'s stream: a recorded CUDA event on the
    card, the host clock elsewhere."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _between(a, b) -> float:
    """Seconds from mark ``a`` to mark ``b`` (both complete)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


def rewind_count() -> int:
    return _REWIND_COUNT


def host_fallback_count() -> int:
    return _HOST_FALLBACKS


def set_host_threads(n: int) -> None:
    """Threads of the native tie replay and decoder (the CLI -t flag)."""
    global _HOST_THREADS
    _HOST_THREADS = max(1, int(n))


def _host_threads() -> int:
    return (
        _HOST_THREADS
        or int(_os.environ.get("GA_THREADS", 0))
        or min(8, _os.cpu_count() or 1)
    )


class _CorrFlags:
    """Interned (correct_from_correct, false_from_correct,
    currently_correct) triple of a finished lane's correctness chain."""

    __slots__ = ("cc", "ffc", "cur")

    def currently_correct(self):
        return self.cur

    def correct_from_correct(self):
        return self.cc

    def false_from_correct(self):
        return self.ffc


_FLAGS_POOL: dict = {}


def _corr_flags(cc, ffc, cur):
    obj = _FLAGS_POOL.get((cc, ffc, cur))
    if obj is None:
        obj = _CorrFlags()
        obj.cc, obj.ffc, obj.cur = cc, ffc, cur
        _FLAGS_POOL[(cc, ffc, cur)] = obj
    return obj


def _decode_tie(traw, ms):
    """Unpack device tie deltas (int16 = 8/8 packing, int32 = 16/16)
    back to absolute (node_min, node_end) via the slice min."""
    if traw.dtype == np.int16:
        t16 = traw.astype(np.int64) & 0xFFFF
        return (t16 & 0xFF) + ms, ((t16 >> 8) & 0xFF) + ms
    t16 = traw.astype(np.int64)
    return (t16 & 0xFFFF) + ms, ((t16 >> 16) & 0xFFFF) + ms


def _quantize_k(k: int) -> int:
    """Walk slice-count ladder {32, 160, 320, ...} (padded slices hold no
    active lane)."""
    if k <= 32:
        return 32
    cap = 160
    while cap < k:
        cap *= 2
    return cap


def _walk_init_state(Bp, keeps, sslot, soff, sscore):
    """Fresh walk lane state [16, Bp] (rows: sk, row_in, slot, off, here,
    done, fail, needs_col, 5 cache words, spares)."""
    st = np.zeros((16, Bp), np.int32)
    st[0] = keeps
    st[1] = 63
    st[2] = sslot
    st[3] = soff
    st[4] = sscore
    st[5] = (keeps < 1).astype(np.int32)
    st[7] = 1
    return st


class _Round:
    """One banded_scan call: the device outputs, the unpacked control
    triple (min_score, num_cells, overflow) the host replay consumes, and
    the request layout: per-step bandwidths [S, B], each request's carry
    ("init" or the _Rec it resumes from), (lane, first step, steps) and
    start slice, and the segment-start mask [S, B]. Other device arrays
    come to the host lazily, each at most once.

    In long mode a round also keeps its scan inputs (``scan_inputs``, to
    recompute it) and, after its replay, each request's last accepted
    slice columns (``cols_last`` [nreq, 7, Cm] at ``last_steps`` /
    ``last_lanes``); ``dropped`` marks a round whose rewind carries are
    gone."""

    def __init__(self, out, control, bw, carry_from, req_meta, req_start,
                 seg_start, scan_inputs=None):
        self.out = out
        self.min_score = control[:, 0]
        self.num_cells = control[:, 1]
        self.overflow = control[:, 2].astype(bool)
        self.bw = bw
        self.carry_from = carry_from
        self.req_meta = req_meta
        self.req_start = req_start
        self.seg_start = seg_start
        self.scan_inputs = scan_inputs
        self.dropped = False
        self._host: dict = {}

    def drop(self, *keys) -> None:
        """Free outputs on the device and their host copies."""
        if "cols" in keys and "sends" in self.out:
            # sends is a view of cols: keep a copy so cols' memory goes
            self.out["sends"] = self.out["sends"].clone()
        for key in keys:
            self.out.pop(key, None)
            self._host.pop(key, None)

    def host(self, key) -> np.ndarray:
        arr = self._host.get(key)
        if arr is None:
            arr = self.out[key].cpu().numpy()
            self._host[key] = arr
        return arr

    def tie16_lane(self, lane: int) -> np.ndarray:
        """[S, Nm] packed tie deltas of one batch lane."""
        return self.host("tie16")[:, :, lane]

    @property
    def tie_ids_sub(self) -> np.ndarray:
        """[ceil(S/8), B] band-row hashes of every 8th slice."""
        return self.host("ids_sub")


@dataclass
class _Rec:
    """Reference to one computed slice of one lane."""

    rnd: _Round
    step: int
    lane_in_round: int
    slice_i: int
    bandwidth: int
    req_i: int = -1  # index into the round's request list

    @property
    def min_score(self) -> int:
        return int(self.rnd.min_score[self.step, self.lane_in_round])

    @property
    def num_cells(self) -> int:
        return int(self.rnd.num_cells[self.step, self.lane_in_round])

    @property
    def overflow(self) -> bool:
        return bool(self.rnd.overflow[self.step, self.lane_in_round])


@dataclass
class _LaneState:
    """Literal replay of getSqrtSlices' control variables for one lane
    (GraphAligner.h:2571-2856)."""

    num_slices: int
    slice_i: int = 0
    ramp_until: int = 0
    ramp_redo_index: int = -1
    last: object = "init"  # "init" | _Rec
    ramp: object = "init"
    correctness: CorrectnessState = field(default_factory=CorrectnessState)
    accepted: list = field(default_factory=list)  # _Rec per table slice
    bandwidths: list = field(default_factory=list)
    corr_list: list = field(default_factory=list)
    done: bool = False
    failed: bool = False  # overflow/fallback

    # chain cursor into the current round
    chain: list = field(default_factory=list)  # [_Rec] sequential records
    cursor: int = 0


class BandedBatchAligner:
    """Batched seeded/banded alignment on one torch device."""

    # reads whose slice bucket passes this window (or the tier's
    # max_window_slices) run the memory-bounded long-read mode: chained
    # scan rounds of one window each whose packed columns are dropped after
    # the control replay, and a backtrace that recomputes one window at a
    # time (the reference's sqrt-slice sampling and getSlicesFromTable
    # recompute, GraphAligner.h:2571-2943). An instance's LONG_WINDOW does
    # not reach its 2x retry tier, which reads the class attribute, as the
    # JAX package's does.
    LONG_WINDOW = 320

    def __init__(
        self,
        graph: AlignmentGraph,
        initial_bandwidth: int,
        ramp_bandwidth: int,
        device,
        Nm: int | None = None,
        Cm: int | None = None,
        max_rounds: int = 6,
        _tables=None,
        _dt=None,
        _rev_pos=None,
        _tier: int = 0,
    ):
        native.get_lib()  # required: fail here, not mid-run
        self.graph = graph
        self.device = torch.device(device)
        self.tables = _tables if _tables is not None else build_graph_tables(graph)
        if self.tables.k_in > 4:
            raise NotImplementedError(
                "the XLA walk (backtrace_device.walk_batch) for graphs of "
                f"in-degree {self.tables.k_in} > 4 is not yet ported"
            )
        self.initial_bandwidth = int(initial_bandwidth)
        self.ramp_bandwidth = int(ramp_bandwidth)
        ew = max(self.initial_bandwidth, self.ramp_bandwidth) + WORD_SIZE
        assert ew < 1023
        if Nm is None:
            # bands reach 26 nodes on longsim (p99 21): 32 node slots
            Nm = 32
        if Cm is None:
            # cell capacity from the bandwidth and the node-length profile
            # (bands hold whole nodes): the first tier as tight as the
            # profile allows, capped at 1152; wider bands retry on the
            # capacity ladder
            p99_len = float(np.percentile(np.asarray(graph.node_len), 99))
            need = min(1152.0, max(2.6 * ew, ew + 2.0 * p99_len))
            Cm = 288
            while Cm < need:
                Cm *= 2
        self.Nm = Nm
        self.Cm = Cm
        self.tier = _tier
        self.max_rounds = max_rounds
        self._long_mode = False
        self._chunk_rounds: list = []
        if _rev_pos is not None:
            self.rev_pos = _rev_pos
        else:
            from .trace_ops import build_reverse_pos

            self.rev_pos = build_reverse_pos(graph)
        self._bigger = None
        # 8-bit tie-break deltas whenever every replay threshold fits
        self._tie8 = ew <= 254
        if _dt is None:
            reach = ensure_reach(self.tables, ew - 1)
            _dt = device_tables(self.tables, reach, self.device)
        self._dt = _dt

    def _next_tier(self):
        """The 2x-capacity retry aligner (sharing graph tables), or None
        at the ladder's top."""
        if self.Nm >= 32 and self.Cm >= 1792:
            return None
        if self._bigger is None:
            self._bigger = BandedBatchAligner(
                self.graph,
                self.initial_bandwidth,
                self.ramp_bandwidth,
                self.device,
                Nm=min(self.Nm * 2, 32),
                Cm=max(self.Cm * 2, 448),
                max_rounds=self.max_rounds,
                _tables=self.tables,
                _dt=self._dt,
                _rev_pos=self.rev_pos,
                _tier=self.tier + 1,
            )
        return self._bigger

    # ------------------------------------------------------------ main entry
    def _plan(self, problems):
        """(S_max, long_mode, rounds_cap, true_S) of a chunk, as JAX's
        _start_run (graphaligner_tpu/core/batch_align.py:719-760): the
        scan length bucketed to {32, 96, 160, then x2}; long mode when the
        bucket passes the window, which then becomes the round length."""
        true_S = max(1, max(len(seq) // WORD_SIZE for seq, _ in problems))
        if true_S <= 32:
            S_max = 32
        elif true_S <= 96:
            S_max = 96
        elif true_S <= 160:
            S_max = 160
        else:
            S_max = 160
            while S_max < true_S:
                S_max *= 2
        window = min(self.LONG_WINDOW, max_window_slices(self.Cm, self.Nm))
        long_mode = S_max > window
        rounds_cap = self.max_rounds
        if long_mode:
            S_max = window
            rounds_cap = max(self.max_rounds, -(-true_S // S_max) + 4)
        return S_max, long_mode, rounds_cap, true_S

    def _run(self, problems):
        """All device rounds + control replay for problems =
        [(padded_sequence, start_node_index)]; returns the final
        per-problem _LaneState list."""
        n = len(problems)
        S_max, long_mode, rounds_cap, true_S = self._plan(problems)
        self._long_mode = long_mode
        self._chunk_rounds = []
        lanes = [
            _LaneState(num_slices=len(seq) // WORD_SIZE) for seq, _ in problems
        ]
        cw = max(S_max, true_S)
        codes = np.full((n, cw * WORD_SIZE), _READ_CODE["N"], dtype=np.uint8)
        seq_lens = np.fromiter((len(seq) for seq, _ in problems), np.int64, n)
        joined = "".join(seq for seq, _ in problems).encode("latin-1")
        enc = _ENCODE_LUT[np.frombuffer(joined, np.uint8)]
        if len(enc) and enc.max(initial=0) == 255:
            bad = joined[int(np.argmax(enc == 255))]
            raise ValueError(f"unsupported read character {chr(bad)!r}")
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(seq_lens, out=offs[1:])
        for i in range(n):
            codes[i, : seq_lens[i]] = enc[offs[i] : offs[i + 1]]
        seq_lens = seq_lens.astype(np.int32)
        self._codes = codes
        self._seq_lens = seq_lens
        requests = [(i, 0, "init", 0) for i in range(n)]
        for round_no in range(rounds_cap):
            if not requests:
                break
            t0, n0 = time.perf_counter(), _k1.LAUNCHES
            rnd = self._round(problems, codes, seq_lens, requests, S_max)
            t1 = time.perf_counter()
            if long_mode:
                _long_add("scan rounds", t1 - t0)
                _long_add("k1 rounds", _k1.LAUNCHES - n0)
                # this round took its carries from the one before: that
                # one's columns can go, and the round before it feeds no
                # rewind any more (JAX :805-818)
                if self._chunk_rounds:
                    self._chunk_rounds[-1].drop("cols", "codes")
                if len(self._chunk_rounds) >= 2:
                    old = self._chunk_rounds[-2]
                    old.drop("sends", "node_min", "node_end")
                    old.dropped = True
                self._chunk_rounds.append(rnd)
            for pos, (i, start, _, _) in enumerate(requests):
                lane = lanes[i]
                l, s0, m = rnd.req_meta[pos]
                lane.chain = [
                    _Rec(rnd, s0 + t, l, start + t, int(rnd.bw[s0 + t, l]), pos)
                    for t in range(m)
                ]
                lane.cursor = 0
            if round_no == 0:
                self._replay_bulk(lanes, requests, rnd)
            requests = []
            for i, lane in enumerate(lanes):
                if lane.done or lane.failed:
                    continue
                req = self._replay(lane)
                if req is not None:
                    if long_mode and req[1] != "init" and req[1].rnd.dropped:
                        # a rewind into a round whose carries were dropped
                        lane.failed = True
                        continue
                    requests.append((i, req[0], req[1], req[2]))
            if long_mode:
                # where the replay cut a chain mid-window (HMM break, ramp
                # rewind), the next window's walk starts below the last
                # ACCEPTED step, the carry, not the last computed one
                overrides = {
                    carry.lane_in_round: carry.step
                    for (_, _, carry, _) in requests
                    if carry != "init" and carry.rnd is rnd
                }
                self._stash_round_boundary(rnd, overrides)
                _long_add("replay", time.perf_counter() - t1)
        if long_mode:
            # the walk recomputes every round, the newest one too
            self._chunk_rounds[-1].drop("cols", "codes")
            _long_peak("peak scan", self.device)
        for lane in lanes:
            if not lane.done:
                lane.failed = True
        return lanes

    def get_traces(self, problems, chunk_size: int = 512):
        """problems → [(score, trace, table_slices, cells) | None]: the
        backtrace of getTraceFromTable per problem, or None for lanes that
        need the host fallback."""
        if not problems:
            return []
        results: list = [None] * len(problems)
        for batch in self.get_traces_stream(problems, chunk_size):
            for i, r in batch.items():
                results[i] = r
        return results

    def get_traces_stream(self, problems, chunk_size: int = 512):
        """Generator form of get_traces: yields {problem_index: result}
        batches chunk by chunk (shortest first). Failed lanes are withheld
        until the capacity-retry tier resolves them; the last batch maps
        the remainder (None = host fallback needed)."""
        order = sorted(
            range(len(problems)),
            key=lambda i: len(problems[i][0]),
            reverse=True,
        )
        chunks = []
        i = 0
        while i < len(order):
            S0 = max(1, len(problems[order[i]][0]) // WORD_SIZE)
            S_bucket = 32
            while S_bucket < S0:
                S_bucket = S_bucket + 64 if S_bucket < 160 else S_bucket * 2
            # cap each chunk so one round's packed columns stay ~1.5 GB
            lane_target = min(
                chunk_size, max(8, int(1.5e9 // (S_bucket * 7 * self.Cm * 4)))
            )
            group = []
            fill: list = []
            while i < len(order):
                n = max(1, len(problems[order[i]][0]) // WORD_SIZE)
                placed = False
                for l in range(len(fill)):
                    if fill[l] + n <= S_bucket:
                        fill[l] += n
                        placed = True
                        break
                if not placed:
                    if len(fill) >= lane_target:
                        break
                    fill.append(n)
                group.append(order[i])
                i += 1
            chunks.append((group, [problems[j] for j in group]))
        chunks.reverse()  # smallest first
        unresolved: list = []
        for idxs, ch in chunks:
            lanes = self._run(ch)
            batch = {}
            for j, r in zip(idxs, self._walk(ch, lanes)):
                if r is None:
                    unresolved.append(j)
                else:
                    batch[j] = r
            yield batch
        # lanes that failed at this capacity retry on the 2x tier before
        # anything falls to the host oracle
        final: dict = {}
        if unresolved:
            bigger = self._next_tier()
            if bigger is not None:
                redo = bigger.get_traces(
                    [problems[j] for j in unresolved], chunk_size
                )
            else:
                redo = [None] * len(unresolved)
            for j, r in zip(unresolved, redo):
                final[j] = r
        yield final

    # ------------------------------------------------------------------ walk
    def _walk(self, problems, lanes):
        """Host control tail (removeWronglyAlignedEnd), walk starts, the
        K2 walk and the native decode."""
        INT_MAX = 2**62
        B = len(lanes)
        results: list = [None] * B
        keeps = np.zeros(B, dtype=np.int32)
        for i, lane in enumerate(lanes):
            if lane.failed:
                continue
            corr = list(lane.corr_list)
            ok = corr[-1].currently_correct() if corr else False
            while not ok:
                if not corr:
                    break
                corr.pop()
                if not corr:
                    break
                ok = corr[-1].false_from_correct()
            keeps[i] = len(corr)
            if len(corr) == 0:
                results[i] = (INT_MAX, [], 0, 0)
        walk_idx = [
            i for i, lane in enumerate(lanes) if not lane.failed and keeps[i] > 0
        ]
        if not walk_idx:
            return results
        if self._long_mode:
            if not moves_walk_fits(self.Cm, self.Nm):
                # the JAX walk fits no window at Cm >= 1792: fail these
                # lanes as it does (JAX :1049-1058)
                for i in walk_idx:
                    lanes[i].failed = True
                return results
            t0 = time.perf_counter()
            self._walk_long(problems, lanes, keeps, walk_idx,
                            list(self._chunk_rounds), results)
            _long_add("walk", time.perf_counter() - t0)
            return results
        big_dev, st = self._gather_walk_inputs(lanes, keeps)
        starts_map: dict = {}
        slow_idx = []
        for i in walk_idx:
            rec_best = lanes[i].accepted[int(keeps[i]) - 1].min_score
            if int(st[i, 0]) != rec_best:
                slow_idx.append(i)  # host/device min divergence
            elif int(st[i, 1]) == 1:
                # unique minimum: the device decision is exact
                starts_map[i] = (int(st[i, 2]), int(st[i, 3]), int(st[i, 4]))
            elif int(st[i, 3]) == int(st[i, 7]):
                # same-node tie: the winner is the node's last tied offset
                starts_map[i] = (int(st[i, 6]), int(st[i, 7]), int(st[i, 8]))
            else:
                slow_idx.append(i)
        if slow_idx:
            # multi-node score ties: the reference picks the LAST minimum
            # in banded-Tarjan collection order (native band-order replay)
            final_sends, final_band = self._fetch_walk_rows(
                big_dev, slow_idx, B
            )
            try:
                slow = self._walk_starts(
                    problems, lanes, keeps, slow_idx, final_sends, final_band
                )
            except AssertionError:
                for i in slow_idx:
                    lanes[i].failed = True
            else:
                for i, s in zip(slow_idx, slow):
                    if s is None:
                        lanes[i].failed = True
                    else:
                        starts_map[i] = s
            walk_idx = [i for i in walk_idx if i in starts_map]
            if not walk_idx:
                return results
        starts = [starts_map[i] for i in walk_idx]
        self._walk_moves(problems, lanes, keeps, walk_idx, starts, results)
        return results

    def _walk_moves(self, problems, lanes, keeps, walk_idx, starts, results):
        """Lanes grouped by quantized table length (sparse rungs ride the
        next rung), one K2 call a group on the card (the chunks that
        ``get_traces``/``get_traces_stream`` hand the walk bound its size),
        and a block of 256 lanes a call on the CPU: the JAX package's walk
        block, so the plain version's lockstep blocks are the JAX
        kernel's."""
        starts_map = dict(zip(walk_idx, starts))
        groups: dict = {}
        for i in walk_idx:
            groups.setdefault(_quantize_k(int(keeps[i])), []).append(i)
        for kq in sorted(groups):
            bigger = [q for q in groups if q > kq]
            if len(groups[kq]) < 32 and bigger:
                groups[min(bigger)].extend(groups.pop(kq))
        for kq in sorted(groups, reverse=True):
            g = groups[kq]
            step = len(g) if self.device.type == "cuda" else 256
            for j in range(0, len(g), step):
                self._walk_block(
                    problems, lanes, keeps, g[j : j + step], starts_map, kq,
                    results,
                )

    def _walk_block(self, problems, lanes, keeps, blk, starts_map, K_max,
                    results):
        """One K2 call over lane subset ``blk`` (table length quantized to
        K_max slices), then the native decode of every live lane."""
        dev = self.device
        n = len(blk)
        Bp = max(128, -(-n // 128) * 128)
        cols_tab, band_tab, lens_tab, pred_tab, pprev_tab, codes8 = (
            self._consolidate_walk(lanes, keeps, K_max, blk, Bp)
        )

        def row1(a):
            a = np.ascontiguousarray(a, dtype=np.int32)
            if Bp != len(a):
                a = np.pad(a, (0, Bp - len(a)))
            return torch.as_tensor(a[None, :], device=dev)

        keeps_b = np.zeros(n, np.int32)
        sslot = np.zeros(n, np.int32)
        soff = np.zeros(n, np.int32)
        sscore = np.zeros(n, np.int32)
        sw = np.zeros(n, np.int64)
        for bi, i in enumerate(blk):
            w0, slot0, off0 = starts_map[i]
            keeps_b[bi] = keeps[i]
            sslot[bi] = slot0
            soff[bi] = off0
            sw[bi] = w0
            sscore[bi] = lanes[i].accepted[int(keeps[i]) - 1].min_score
        seed_nodes = np.array([problems[i][1] for i in blk], dtype=np.int32)
        pad = lambda a: np.pad(a, (0, Bp - n))  # noqa: E731
        init_state = _walk_init_state(
            Bp, pad(keeps_b), pad(sslot), pad(soff), pad(sscore)
        )
        # whole-table walk = one window with base 0 (the consolidation
        # grew the leading below-window pad slice)
        moves_dev, fail_dev, _state, used_dev = walk_moves(
            cols_tab, band_tab, lens_tab, pred_tab, pprev_tab, codes8,
            self._dt.bt_bits_lut,
            row1(self._seq_lens[blk]),
            row1(seed_nodes),
            torch.zeros((1, Bp), dtype=torch.int32, device=dev),
            torch.as_tensor(init_state, device=dev),
            K_in=self.tables.k_in,
        )
        T_w = moves_dev.shape[0]
        rows = min(T_w, int(used_dev.max()) // 8 + 1)
        moves = np.ascontiguousarray(moves_dev[:rows].cpu().numpy()).view(
            np.uint32
        )
        fail = fail_dev.cpu().numpy()[0]
        t = self.tables
        node_start64 = np.ascontiguousarray(self.graph.node_start, dtype=np.int64)
        node_end64 = np.ascontiguousarray(self.graph.node_end, dtype=np.int64)
        pos2node = np.ascontiguousarray(t.pos_to_node)
        in_nbrs = np.ascontiguousarray(t.in_nbrs)
        cap = K_max * WORD_SIZE * 3 + 64
        live = [(col, i) for col, i in enumerate(blk) if not fail[col]]
        for col, i in enumerate(blk):
            if fail[col]:
                lanes[i].failed = True
        if not live:
            return
        cols_a = np.array([c for c, _ in live], dtype=np.int32)
        sw_a = np.array([sw[c] for c, _ in live], dtype=np.int64)
        sr_a = np.array(
            [int(keeps[i]) * WORD_SIZE - 1 for _, i in live], dtype=np.int64
        )
        out_w, out_r, n_out = native.decode_moves_batch(
            moves, cols_a, sw_a, sr_a, node_start64, node_end64, pos2node,
            in_nbrs, cap, _host_threads(),
        )
        for j, (_, i) in enumerate(live):
            m = int(n_out[j])
            lane = lanes[i]
            if m < 1 or out_r[j, 0] != 0:
                lane.failed = True
                continue
            arr = np.stack([out_w[j, :m], out_r[j, :m]], axis=1)
            score = lane.accepted[int(keeps[i]) - 1].min_score
            cells = sum(
                r.num_cells for r in lane.accepted[: int(keeps[i])]
            ) * WORD_SIZE
            results[i] = (score, arr, int(keeps[i]), cells)

    def _gather_walk_inputs(self, lanes, keeps):
        """Every walk lane's final slice, gathered on the device: a
        [B, Cm+Nm] payload (last-row scores + band ids) that stays there,
        and a [B, 10] start summary fetched to the host (best, nmins, pos,
        slot, off, node of the first minimum, pos/slot/off/node of the
        last): unique minima and same-node ties resolve from it directly
        (min_score_index.back(), GraphAligner.h:2359-2366)."""
        dev = self.device
        B = len(lanes)
        Cm, Nm = self.Cm, self.Nm
        acc_big = torch.zeros((B, Cm + Nm), dtype=torch.int32, device=dev)
        acc_st = torch.zeros((B, 10), dtype=torch.int32, device=dev)
        rounds = []
        for i, lane in enumerate(lanes):
            if not lane.failed and keeps[i] > 0:
                rec = lane.accepted[int(keeps[i]) - 1]
                if rec.rnd not in rounds:
                    rounds.append(rec.rnd)
        big = 2**31 - 1
        cm_idx = torch.arange(Cm, device=dev)[None, :]
        node_start = self._dt.node_start
        for rnd in rounds:
            steps = np.zeros(B, dtype=np.int64)
            lane_pos = np.zeros(B, dtype=np.int64)
            mask = np.zeros(B, dtype=bool)
            for i, lane in enumerate(lanes):
                if lane.failed or keeps[i] == 0:
                    continue
                rec = lane.accepted[int(keeps[i]) - 1]
                if rec.rnd is rnd:
                    steps[i] = rec.step
                    lane_pos[i] = rec.lane_in_round
                    mask[i] = True
            steps_t = torch.as_tensor(steps, device=dev)
            lane_t = torch.as_tensor(lane_pos, device=dev)
            mask_t = torch.as_tensor(mask, device=dev)
            sends = rnd.out["sends"][steps_t, :, lane_t]  # [B, Cm]
            band = rnd.out["band_ids"][steps_t, :, lane_t]  # [B, Nm]
            lens = rnd.out["lens_tab"][steps_t, :, lane_t]
            valid = band != int(EMPTY)
            lens = torch.where(valid, lens, 0)
            offs = lens.cumsum(1, dtype=torch.int32) - lens
            c_used = lens.sum(1)
            masked = torch.where(cm_idx < c_used[:, None], sends, big)
            best = masked.min(1).values
            is_min = (masked == best[:, None]).to(torch.int8)
            nmins = is_min.sum(1, dtype=torch.int32)

            def locate(cell):
                slot = ((offs <= cell[:, None]) & valid).sum(1) - 1
                slot_c = slot.clamp(0, Nm - 1)[:, None]
                off = cell - offs.gather(1, slot_c)[:, 0]
                node = band.gather(1, slot_c)[:, 0]
                pos = node_start[node.clamp(0, node_start.shape[0] - 1).long()] + off
                return pos, slot, off, node

            first = is_min.argmax(1)
            last = (Cm - 1) - is_min.flip(1).argmax(1)
            summary = torch.stack(
                [x.to(torch.int32)
                 for x in (best, nmins, *locate(first), *locate(last))],
                dim=1,
            )
            src = torch.cat([sends, band], dim=1)
            acc_big = torch.where(mask_t[:, None], src, acc_big)
            acc_st = torch.where(mask_t[:, None], summary, acc_st)
        return acc_big, acc_st.cpu().numpy()

    def _fetch_walk_rows(self, big_dev, idxs, B):
        """(final_sends [B, Cm], final_band [B, Nm]) host arrays with only
        the rows of lanes ``idxs`` filled."""
        final_sends = np.zeros((B, self.Cm), np.int32)
        final_band = np.full((B, self.Nm), int(EMPTY), np.int32)
        rows = big_dev[torch.as_tensor(idxs, device=self.device)].cpu().numpy()
        final_sends[idxs] = rows[:, : self.Cm]
        final_band[idxs] = rows[:, self.Cm :]
        return final_sends, final_band

    def _walk_starts(self, problems, lanes, keeps, walk_idx, final_sends,
                     final_band):
        """Backtrace start per lane: min_score_index.back() of the final
        surviving slice in the reference's banded-Tarjan collection order
        (GraphAligner.h:2359-2366). Unique minima and same-node ties are
        decided vectorized; multi-node ties go to ONE native call
        (ga_tie_batch: band-order chain replay + last-min scan)."""
        g = self.graph
        t = self.tables
        widx = np.asarray(walk_idx)
        fb = final_band[widx]  # [W, Nm]
        valid = fb != EMPTY
        lens_w = np.where(valid, t.node_len[np.clip(fb, 0, t.num_nodes - 1)], 0)
        offs_w = np.cumsum(lens_w, axis=1) - lens_w
        c_used_w = lens_w.sum(axis=1)
        best_w = np.array(
            [lanes[i].accepted[int(keeps[i]) - 1].min_score for i in walk_idx]
        )
        sends_w = final_sends[widx]
        cells_idx = np.arange(sends_w.shape[1])[None, :]
        is_min = (sends_w == best_w[:, None]) & (cells_idx < c_used_w[:, None])
        nmins = is_min.sum(axis=1)
        first_cell = np.argmax(is_min, axis=1)
        slot_w = ((offs_w <= first_cell[:, None]) & valid).sum(axis=1) - 1
        off_w = first_cell - offs_w[np.arange(len(widx)), slot_w]
        node_w = fb[np.arange(len(widx)), slot_w]
        pos_w = np.asarray(g.node_start)[node_w] + off_w
        last_cell = sends_w.shape[1] - 1 - np.argmax(is_min[:, ::-1], axis=1)
        slot_l = ((offs_w <= last_cell[:, None]) & valid).sum(axis=1) - 1
        off_l = last_cell - offs_w[np.arange(len(widx)), slot_l]
        node_l = fb[np.arange(len(widx)), slot_l]
        pos_l = np.asarray(g.node_start)[node_l] + off_l
        same_node = slot_w == slot_l

        starts: list = [None] * len(walk_idx)
        tie_idx = []
        for w, i in enumerate(walk_idx):
            if nmins[w] == 0:
                continue  # no cell holds the accepted min: fail the lane
            if nmins[w] == 1:
                starts[w] = (int(pos_w[w]), int(slot_w[w]), int(off_w[w]))
            elif same_node[w]:
                starts[w] = (int(pos_l[w]), int(slot_l[w]), int(off_l[w]))
            else:
                tie_idx.append((w, i))
        if not tie_idx:
            return starts
        W = len(tie_idx)
        Kmax = max(int(keeps[i]) for _, i in tie_idx)
        Nm = self.Nm
        tie_b = np.zeros((W, Kmax, 3, Nm), np.int32)
        chk_b = np.zeros((W, Kmax), np.uint8)
        ms_b = np.zeros((W, Kmax), np.int32)
        bw_b = np.zeros((W, Kmax), np.int32)
        Ks = np.zeros(W, np.int32)
        sn_b = np.zeros(W, np.int32)
        bests_b = np.zeros(W, np.int32)
        for k, (w, i) in enumerate(tie_idx):
            keep = int(keeps[i])
            tie, check, ms = self._tie_chain_inputs(lanes[i].accepted[:keep])
            tie_b[k, :keep] = tie
            chk_b[k, :keep] = check
            ms_b[k, :keep] = ms
            bw_b[k, :keep] = lanes[i].bandwidths[:keep]
            Ks[k] = keep
            sn_b[k] = problems[i][1]
            bests_b[k] = ms[keep - 1]
        sends_b = final_sends[[i for _, i in tie_idx]]
        pos_b, rc_b = native.tie_batch(
            tie_b, ms_b, bw_b, Ks, sn_b, chk_b, sends_b, bests_b,
            g, t.topo_rank, ALTERNATE_METHOD_CUTOFF, int(EMPTY),
            _host_threads(),
        )
        p2n = t.pos_to_node
        node_start = np.asarray(g.node_start)
        for k, (w, i) in enumerate(tie_idx):
            if rc_b[k] != 0 or pos_b[k] < 0:
                # host/device band divergence (or no tied min): fail only
                # this lane — it re-runs on the retry ladder
                lanes[i].failed = True
                continue
            pos = int(pos_b[k])
            node = int(p2n[pos])
            hit = np.nonzero(fb[w] == node)[0]
            if len(hit) == 0:
                lanes[i].failed = True
                continue
            starts[w] = (pos, int(hit[0]), pos - int(node_start[node]))
        return starts

    def _consolidate_walk(self, lanes, keeps, K_max, blk, Bp):
        """Walk tables of lanes ``blk``, gathered on the device from each
        round's outputs: (cols [K_max+1, 7, Cm, Bp], band, lens, pred,
        pred_prev [K_max+1, Nm, Bp], codes [K_max+1, 64, Bp] uint8), lane-
        padded to Bp, with entry 0 the walk's below-window pad slice."""
        dev = self.device
        rounds = []
        for li in blk:
            for rec in lanes[li].accepted:
                if rec.rnd not in rounds:
                    rounds.append(rec.rnd)
        K1 = K_max + 1
        tabs = None
        for rnd in rounds:
            steps = np.zeros((K1, Bp), np.int64)
            mask = np.zeros((K1, Bp), bool)
            lane_pos = np.zeros(Bp, np.int64)
            for bi, li in enumerate(blk):
                lane = lanes[li]
                if lane.failed:
                    continue
                for k, rec in enumerate(lane.accepted[: int(keeps[li])]):
                    if rec.rnd is rnd:
                        steps[k + 1, bi] = rec.step
                        mask[k + 1, bi] = True
            for bi, li in enumerate(blk):
                for rec in lanes[li].accepted:
                    if rec.rnd is rnd:
                        lane_pos[bi] = rec.lane_in_round
                        break
            st = torch.as_tensor(steps, device=dev)
            ln = torch.as_tensor(lane_pos, device=dev)[None, :]
            m3 = torch.as_tensor(mask, device=dev)[:, None, :]
            gathered = [
                rnd.out[key][st, :, ln].permute(0, 2, 1)
                for key in ("band_ids", "lens_tab", "pred_tab", "pred_prev")
            ]
            gathered.append(rnd.out["codes"][st, :, ln].permute(0, 2, 1))
            cols = rnd.out["cols"][st, :, :, ln].permute(0, 2, 3, 1)
            if tabs is None:
                fills = (int(EMPTY), 0, 0, 0, 0)
                tabs = [
                    torch.where(m3, g_, torch.full_like(g_, f))
                    for g_, f in zip(gathered, fills)
                ]
                cols_t = torch.where(m3[:, None], cols, torch.zeros_like(cols))
            else:
                tabs = [torch.where(m3, g_, a) for g_, a in zip(gathered, tabs)]
                cols_t = torch.where(m3[:, None], cols, cols_t)
        band_t, lens_t, pred_t, pprev_t, codes_t = (
            t_.contiguous() for t_ in tabs
        )
        return cols_t.contiguous(), band_t, lens_t, pred_t, pprev_t, codes_t

    def _walk_long(self, problems, lanes, keeps, walk_idx, chunk_rounds,
                   results):
        """The windowed backtrace of a long-mode chunk (JAX ``_walk_long``,
        graphaligner_tpu/core/batch_align.py:1912-2222): for each round,
        newest first, its columns are recomputed, the lanes whose table
        ends there get their walk starts, and K2 walks the window from the
        lane state the newer window left. The windows' move streams,
        concatenated, decode as one walk's."""
        dev = self.device
        Cm, Nm = self.Cm, self.Nm
        B = len(lanes)
        # lanes padded as _walk_block pads them, on every device: the plain
        # walk's lockstep blocks are then the TPU kernel's, and on the card
        # the pad lanes are idle warps (state[5] = 1)
        Bp = max(128, -(-B // 128) * 128)
        NO_BASE = -(10**6)
        marks: list = []  # (key, start, end) of each recompute and window

        # each lane's table as straight segments, one a round:
        # [rnd, first step, slices, first slice, lane_in_round]
        lane_segs: dict = {}
        for i in walk_idx:
            segs: list = []
            ok = True
            for rec in lanes[i].accepted[: int(keeps[i])]:
                if (
                    segs
                    and segs[-1][0] is rec.rnd
                    and rec.step == segs[-1][1] + segs[-1][2]
                    and rec.slice_i == segs[-1][3] + segs[-1][2]
                ):
                    segs[-1][2] += 1
                elif not segs or segs[-1][0] is not rec.rnd:
                    segs.append(
                        [rec.rnd, rec.step, 1, rec.slice_i, rec.lane_in_round]
                    )
                else:
                    ok = False
                    break
            # the segments must tile the table from slice 0 on
            ok = ok and [s_[3] for s_ in segs] == list(
                np.cumsum([0] + [s_[2] for s_ in segs[:-1]])
            )
            if not ok or not segs:
                # a rewound chain lost its dropped columns: the retry tier
                # (or the host fallback) takes the lane
                lanes[i].failed = True
                continue
            lane_segs[i] = segs
        live = [i for i in walk_idx if i in lane_segs]
        if not live:
            return
        _long_add("lanes", len(live))
        rounds = [
            r for r in chunk_rounds
            if any(s_[0] is r for i in live for s_ in lane_segs[i])
        ]

        def row1(a):
            out = np.zeros((1, Bp), np.int32)
            out[0, :B] = a
            return torch.as_tensor(out, device=dev)

        seq_row = row1(self._seq_lens)
        seed_row = row1([p[1] for p in problems])
        state = np.zeros((16, Bp), np.int32)
        state[5] = 1  # idle until the lane's last window starts it
        sw = np.zeros(B, dtype=np.int64)
        move_parts: list = []
        S_g = self._codes.shape[1] // WORD_SIZE
        codes_all = self._codes.reshape(B, S_g, WORD_SIZE)

        for rnd in reversed(rounds):
            segs_here = {
                i: s_
                for i in live
                for s_ in lane_segs[i]
                if s_[0] is rnd and not lanes[i].failed
            }
            if not segs_here:
                continue
            m0, n0 = _mark(dev), _k1.LAUNCHES
            out = self._redispatch_round(rnd)
            marks.append(("recompute", m0, _mark(dev)))
            _long_add("k1 recompute", _k1.LAUNCHES - n0)
            _long_add("lane windows", len(segs_here))
            K_w = max(s_[2] for s_ in segs_here.values())
            steps_map = np.zeros((K_w, B), np.int64)
            valid_map = np.zeros((K_w, B), bool)
            base = np.full(B, NO_BASE, np.int32)
            lr = np.zeros(B, np.int64)
            for i, (_, step0, n, g0, lane_r) in segs_here.items():
                base[i] = g0
                lr[i] = lane_r
                steps_map[:n, i] = step0 + np.arange(n)
                valid_map[:n, i] = True
            st_t = torch.as_tensor(steps_map, device=dev)
            lr_t = torch.as_tensor(lr, device=dev)[None, :]
            vm = torch.as_tensor(valid_map, device=dev)[:, None, :]

            # the window's tables by (step, lane_in_round), gathered for the
            # B lanes into buffers of Bp; entry 0, the slice below the
            # window, is the lane's previous segment's last slice from that
            # round's stash
            keys = ("band_ids", "lens_tab", "pred_tab", "pred_prev")
            tabs = []
            for key, fill in zip(keys, (int(EMPTY), 0, 0, 0)):
                t_ = torch.full((K_w + 1, Nm, Bp), fill, dtype=torch.int32,
                                device=dev)
                g_ = rnd.out[key][st_t, :, lr_t].permute(0, 2, 1)
                t_[1:, :, :B] = torch.where(vm, g_, fill)
                tabs.append(t_)
            cols_w = torch.zeros((K_w + 1, 7, Cm, Bp), dtype=torch.int32,
                                 device=dev)
            cols_w[1:, :, :, :B] = torch.where(
                vm[:, None], out["cols"][st_t, :, :, lr_t].permute(0, 2, 3, 1),
                0,
            )
            by_prev: dict = {}
            for i, s_ in segs_here.items():
                segs = lane_segs[i]
                k = segs.index(s_)
                if k > 0:
                    p_ = segs[k - 1]
                    by_prev.setdefault(id(p_[0]), (p_[0], []))[1].append(
                        (i, p_)
                    )
            for prnd, pairs in by_prev.values():
                # a stash miss (a rewind moved an older round's segment end
                # after its stash was taken) fails the lane to the retry
                # ladder (JAX :2042-2057)
                good, reqpos = [], []
                for i, p_ in pairs:
                    hits = np.nonzero(
                        (prnd.last_lanes == p_[4])
                        & (prnd.last_steps == p_[1] + p_[2] - 1)
                    )[0]
                    if len(hits) == 0:
                        lanes[i].failed = True
                        continue
                    good.append((i, p_))
                    reqpos.append(int(hits[0]))
                if not good:
                    continue
                idx = torch.as_tensor([i for i, _ in good], device=dev)
                plast = torch.as_tensor([p_[1] + p_[2] - 1 for _, p_ in good],
                                        device=dev)
                plane = torch.as_tensor([p_[4] for _, p_ in good], device=dev)
                # (no name may keep a view of a buffer: each must go with
                # its window)
                cols_w[0][:, :, idx] = prnd.cols_last[
                    torch.as_tensor(reqpos, device=dev)
                ].permute(1, 2, 0)
                for j, key in enumerate(keys):
                    tabs[j][0][:, idx] = prnd.out[key][plast, :, plane].T
            band_w, lens_w, pred_w, pprev_w = tabs

            # lanes whose table ends in this window start walking here
            starters = [
                i
                for i, s_ in segs_here.items()
                if s_[3] + s_[2] == int(keeps[i]) and not lanes[i].failed
            ]
            if starters:
                fin_step = torch.as_tensor(
                    [segs_here[i][1] + segs_here[i][2] - 1 for i in starters],
                    device=dev,
                )
                fin_lane = torch.as_tensor(
                    [segs_here[i][4] for i in starters], device=dev
                )
                final_sends = np.zeros((B, Cm), np.int32)
                final_band = np.full((B, Nm), int(EMPTY), np.int32)
                final_sends[starters] = (
                    out["sends"][fin_step, :, fin_lane].cpu().numpy()
                )
                final_band[starters] = (
                    rnd.out["band_ids"][fin_step, :, fin_lane].cpu().numpy()
                )
                try:
                    starts = self._walk_starts(
                        problems, lanes, keeps, starters, final_sends,
                        final_band,
                    )
                except AssertionError:
                    for i in starters:
                        lanes[i].failed = True
                    starts = []
                for i, s0_ in zip(starters, starts):
                    if s0_ is None:
                        lanes[i].failed = True
                        continue
                    sw[i] = s0_[0]
                    state[:, i] = 0
                    state[0, i] = int(keeps[i])
                    state[1, i] = 63
                    state[2, i] = s0_[1]
                    state[3, i] = s0_[2]
                    state[4, i] = lanes[i].accepted[int(keeps[i]) - 1].min_score
                    state[7, i] = 1
            del out

            codes_rows = np.clip(
                base[:, None] + np.arange(K_w + 1, dtype=np.int32)[None, :] - 1,
                0, S_g - 1,
            )
            base_row = np.full((1, Bp), NO_BASE, np.int32)
            base_row[0, :B] = base
            codes8 = np.zeros((K_w + 1, WORD_SIZE, Bp), np.uint8)
            codes8[:, :, :B] = codes_all[
                np.arange(B)[:, None], codes_rows
            ].transpose(1, 2, 0)
            codes8_t = torch.as_tensor(codes8, device=dev)
            base_t = torch.as_tensor(base_row, device=dev)
            state_t = torch.as_tensor(state, device=dev)
            m0, n0 = _mark(dev), _k2.LAUNCHES
            moves_dev, fail_dev, state_dev, _ = walk_moves(
                cols_w, band_w, lens_w, pred_w, pprev_w, codes8_t,
                self._dt.bt_bits_lut, seq_row, seed_row, base_t, state_t,
                K_in=self.tables.k_in,
            )
            marks.append(("K2 windows", m0, _mark(dev)))
            _long_add("k2", _k2.LAUNCHES - n0)
            state = state_dev.cpu().numpy().copy()
            fail = fail_dev.cpu().numpy()[0]
            for i in segs_here:
                if fail[i]:
                    lanes[i].failed = True
                    state[5, i] = 1
            move_parts.append(moves_dev.cpu().numpy().view(np.uint32))
            # the next round's recompute and window come after these go
            del cols_w, tabs, t_, band_w, lens_w, pred_w, pprev_w
        # the last window's copies above synchronized every mark
        for key, a, b in marks:
            _long_add(key, _between(a, b))
        _long_peak("peak walk", dev)

        final_live = []
        for i in live:
            if lanes[i].failed:
                continue
            if state[5, i] == 1:
                final_live.append(i)
            else:
                lanes[i].failed = True  # never finished across the windows
        if not final_live:
            return
        moves = np.concatenate(move_parts, axis=0)
        t = self.tables
        node_start64 = np.ascontiguousarray(self.graph.node_start, dtype=np.int64)
        node_end64 = np.ascontiguousarray(self.graph.node_end, dtype=np.int64)
        pos2node = np.ascontiguousarray(t.pos_to_node)
        in_nbrs = np.ascontiguousarray(t.in_nbrs)
        # one decode a trace capacity: the JAX package decodes each lane
        # with cap = keeps * 64 * 3 + 64 and fails it past that
        by_cap: dict = {}
        for i in final_live:
            by_cap.setdefault(int(keeps[i]) * WORD_SIZE * 3 + 64, []).append(i)
        for cap, grp in by_cap.items():
            out_w, out_r, n_out = native.decode_moves_batch(
                moves, np.array(grp, np.int32), sw[grp],
                keeps[grp].astype(np.int64) * WORD_SIZE - 1,
                node_start64, node_end64, pos2node, in_nbrs, cap,
                _host_threads(),
            )
            for j, i in enumerate(grp):
                m = int(n_out[j])
                lane = lanes[i]
                if m < 1 or out_r[j, 0] != 0:
                    lane.failed = True
                    continue
                arr = np.stack([out_w[j, :m], out_r[j, :m]], axis=1)
                score = lane.accepted[int(keeps[i]) - 1].min_score
                cells = sum(
                    r.num_cells for r in lane.accepted[: int(keeps[i])]
                ) * WORD_SIZE
                results[i] = (score, arr, int(keeps[i]), cells)

    # ------------------------------------------------------------- device round
    @staticmethod
    def _ffd_pack(sizes, cap, opens):
        """First-fit-decreasing packing of request slice-counts into
        lanes of `cap` steps. opens[r] forces request r to open a fresh
        lane at step 0 (carried rewinds consume the init_* carry slot).
        Returns (lane_of, step0_of, n_lanes); deterministic."""
        order = sorted(range(len(sizes)), key=lambda r: (-sizes[r], r))
        fill = []
        lane_of = [0] * len(sizes)
        step0_of = [0] * len(sizes)
        for r in order:
            n = max(1, sizes[r])
            if opens[r]:
                lane_of[r] = len(fill)
                step0_of[r] = 0
                fill.append(n)
                continue
            placed = False
            for l in range(len(fill)):
                if fill[l] + n <= cap:
                    lane_of[r] = l
                    step0_of[r] = fill[l]
                    fill[l] += n
                    placed = True
                    break
            if not placed:
                lane_of[r] = len(fill)
                step0_of[r] = 0
                fill.append(n)
        return lane_of, step0_of, max(1, len(fill))

    def _round(self, problems, codes, seq_lens, requests, S_max) -> _Round:
        """Pack the requests' slice ranges into scan lanes (segment starts
        reset the carry in-scan), run one banded_scan round and unpack its
        control words."""
        sizes = [
            min(S_max, max(0, (len(problems[i][0]) // WORD_SIZE) - st))
            for (i, st, _, _) in requests
        ]
        opens = [carry != "init" for (_, _, carry, _) in requests]
        lane_of, step0_of, n_lanes = self._ffd_pack(sizes, S_max, opens)
        if n_lanes <= 32:
            B = 32
        elif n_lanes <= 256:
            B = 256
        else:
            B = 512
            while B < n_lanes:
                B *= 2
        bw = np.full((S_max, B), self.initial_bandwidth, dtype=np.int32)
        codes_lane = np.full(
            (B, S_max * WORD_SIZE), _READ_CODE["N"], dtype=np.uint8
        )
        seg_active = np.zeros((S_max, B), dtype=np.int32)
        seg_first = np.zeros((S_max, B), dtype=np.int32)
        seg_slen = np.zeros((S_max, B), dtype=np.int32)
        seg_rnode = np.full((S_max, B), -1, dtype=np.int32)
        seg_rlen = np.zeros((S_max, B), dtype=np.int32)
        seg_start_mask = np.zeros((S_max, B), dtype=bool)
        init_ids = np.full((B, self.Nm), EMPTY, dtype=np.int32)
        init_send = np.full((B, self.Cm), INF, dtype=np.int32)
        init_nmin = np.full((B, self.Nm), INF, dtype=np.int32)
        init_nend = np.full((B, self.Nm), INF, dtype=np.int32)
        init_min = np.zeros(B, dtype=np.int32)

        carry_groups: dict = {}  # id(rnd) -> (rnd, [(lane, rec)])
        req_meta = []
        for pos, (i, st, carry, ramp_until) in enumerate(requests):
            l, s0, n = lane_of[pos], step0_of[pos], sizes[pos]
            req_meta.append((l, s0, n))
            codes_lane[l, s0 * WORD_SIZE : (s0 + n) * WORD_SIZE] = codes[
                i, st * WORD_SIZE : (st + n) * WORD_SIZE
            ]
            seg_active[s0 : s0 + n, l] = 1
            seg_slen[s0 : s0 + n, l] = seq_lens[i]
            seg_start_mask[s0, l] = True
            if st == 0:
                seg_first[s0, l] = 1
            hi = min(n, ramp_until - st + 1)
            if hi > 0:
                bw[s0 : s0 + hi, l] = self.ramp_bandwidth
            if carry == "init":
                node = problems[i][1]
                seg_rnode[s0, l] = node
                seg_rlen[s0, l] = int(self.tables.node_len[node])
            else:
                rec: _Rec = carry
                carry_groups.setdefault(id(rec.rnd), (rec.rnd, []))[1].append(
                    (l, rec)
                )
                init_min[l] = rec.min_score
        # rewind carries: one device gather + fetch per source round
        for rnd_src, recs in carry_groups.values():
            steps_a = torch.as_tensor([r.step for _, r in recs],
                                      device=self.device)
            lanes_a = torch.as_tensor([r.lane_in_round for _, r in recs],
                                      device=self.device)
            o = rnd_src.out
            packed = torch.cat(
                [o[key][steps_a, :, lanes_a]
                 for key in ("band_ids", "node_min", "node_end", "sends")],
                dim=1,
            ).cpu().numpy()  # [n, 3*Nm + Cm]
            Nm = self.Nm
            for j, (l, _) in enumerate(recs):
                init_ids[l] = packed[j, :Nm]
                init_nmin[l] = packed[j, Nm : 2 * Nm]
                init_nend[l] = packed[j, 2 * Nm : 3 * Nm]
                init_send[l] = packed[j, 3 * Nm :]

        zeros_b = np.zeros(B, dtype=np.int32)
        seg = (seg_active, seg_first, seg_slen, seg_rnode, seg_rlen)
        out = banded_scan(
            self._dt, codes_lane, zeros_b, zeros_b, zeros_b, bw,
            init_ids, init_send, init_nmin, init_nend, init_min,
            S_max=S_max, Nm=self.Nm, Cm=self.Cm, seg=seg, tie8=self._tie8,
        )
        return _Round(
            out,
            control=self._unpack_control(
                out["control"].cpu().numpy(), init_min, seg_active, seg_rnode
            ),
            bw=bw,
            carry_from=[r[2] for r in requests],
            req_meta=req_meta,
            req_start=np.array([r[1] for r in requests], dtype=np.int32),
            seg_start=seg_start_mask,
            scan_inputs=(
                codes_lane, bw, init_ids, init_send, init_nmin, init_nend,
                init_min, seg, S_max,
            ) if self._long_mode else None,
        )

    def _redispatch_round(self, rnd) -> dict:
        """A long-mode round run again from its scan inputs (JAX
        :2461-2490): the scan is deterministic (a stable sort, no atomics),
        so the recomputed outputs equal the dropped ones bit for bit (the
        reference's getSlicesFromTable recompute, GraphAligner.h:2858-2943)."""
        (codes_lane, bw, init_ids, init_send, init_nmin, init_nend, init_min,
         seg, S_max) = rnd.scan_inputs
        zeros_b = np.zeros(codes_lane.shape[0], dtype=np.int32)
        return banded_scan(
            self._dt, codes_lane, zeros_b, zeros_b, zeros_b, bw,
            init_ids, init_send, init_nmin, init_nend, init_min,
            S_max=S_max, Nm=self.Nm, Cm=self.Cm, seg=seg, tie8=self._tie8,
        )

    def _stash_round_boundary(self, rnd, overrides) -> None:
        """Before a long-mode round's columns go: each request's last
        accepted slice columns, the below-window slice of the next window's
        walk, as a [nreq, 7, Cm] gather (JAX :2492-2510). ``overrides`` maps
        lane_in_round -> the step the replay cut a chain at."""
        steps = np.array(
            [overrides.get(l, s0 + n - 1) for (l, s0, n) in rnd.req_meta],
            dtype=np.int64,
        )
        lanes_ = np.array([l for (l, _, _) in rnd.req_meta], dtype=np.int64)
        rnd.cols_last = rnd.out["cols"][
            torch.as_tensor(steps, device=self.device), :, :,
            torch.as_tensor(lanes_, device=self.device),
        ]
        rnd.last_steps = steps
        rnd.last_lanes = lanes_

    @staticmethod
    def _unpack_control(ctrl, init_min, seg_active, seg_rnode):
        """Host mirror of the engine's packed-control reconstruction
        (delta|cells<<7|ovf<<30 per (step, lane)): absolute minima = delta
        cumsum with resets at fresh-problem segment starts and init_min as
        each lane's carry base. Returns the [S, 3, B] (min_score,
        num_cells, overflow) triple."""
        delta = (ctrl & 127).astype(np.int32)
        cells = ((ctrl >> 7) & 0x7FFFFF).astype(np.int32)
        ovf = ((ctrl >> 30) & 1).astype(np.int32)
        S, B = ctrl.shape
        cs = np.cumsum(delta, axis=0, dtype=np.int32)
        reset = seg_rnode >= 0
        idx = np.where(reset, np.arange(S, dtype=np.int32)[:, None], -1)
        last_reset = np.maximum.accumulate(idx, axis=0)
        prev_cs = np.concatenate([np.zeros((1, B), np.int32), cs[:-1]], axis=0)
        base = np.where(
            last_reset >= 0,
            -np.take_along_axis(prev_cs, np.maximum(last_reset, 0), axis=0),
            init_min[None, :].astype(np.int32),
        )
        ms = np.where(seg_active == 1, cs + base, np.int32(INF))
        return np.stack([ms, cells, ovf], axis=1)

    def _replay_bulk(self, lanes, requests, rnd):
        """Vectorized fast path of the getSqrtSlices replay for round-1
        'init' lanes: the HMM chain is a per-lane float64 recurrence
        (bit-identical op order to hmm.CorrectnessState.next_state), so
        all lanes advance in one numpy sweep. Lanes whose chain hits an
        overflow, a possible ramping rewind, or any irregularity are
        left untouched for the literal scalar replay below."""
        import math

        S, B = rnd.min_score.shape
        ms = rnd.min_score.astype(np.float64)
        seg0 = rnd.seg_start
        prev = np.concatenate([np.zeros((1, B)), ms[:-1]], axis=0)
        prev = np.where(seg0, 0.0, prev)  # each segment's chain starts at 0
        delta = np.clip((ms - prev).astype(np.int64), 0, WORD_SIZE)
        lut = np.asarray(_hmm._LOG_FACTORIALS)
        log_choose = lut[WORD_SIZE] - lut[delta] - lut[WORD_SIZE - delta]
        c = np.full(B, math.log(0.8))
        f = np.full(B, math.log(0.2))
        CFC = np.zeros((S, B), bool)
        FFC = np.zeros((S, B), bool)
        CUR = np.zeros((S, B), bool)
        lp8, lp2 = math.log(0.8), math.log(0.2)
        for k in range(S):
            if seg0[k].any():
                c = np.where(seg0[k], lp8, c)
                f = np.where(seg0[k], lp2, f)
            CFC[k] = c + _hmm._CORRECT_TO_CORRECT >= f + _hmm._FALSE_TO_CORRECT
            FFC[k] = c + _hmm._CORRECT_TO_FALSE >= f + _hmm._FALSE_TO_FALSE
            nc = np.maximum(
                c + _hmm._CORRECT_TO_CORRECT, f + _hmm._FALSE_TO_CORRECT
            )
            nf = np.maximum(
                c + _hmm._CORRECT_TO_FALSE, f + _hmm._FALSE_TO_FALSE
            )
            d = delta[k]
            nc = nc + log_choose[k] + d * _hmm._CORRECT_MISMATCH + (
                WORD_SIZE - d
            ) * _hmm._CORRECT_MATCH
            nf = nf + log_choose[k] + d * _hmm._FALSE_MISMATCH + (
                WORD_SIZE - d
            ) * _hmm._FALSE_MATCH
            c, f = nc, nf
            CUR[k] = c > f
        ramping = self.ramp_bandwidth > self.initial_bandwidth
        for pos, (i, st, carry, ramp_until) in enumerate(requests):
            lane = lanes[i]
            if carry != "init" or st != 0 or ramp_until != 0:
                continue
            l, s0, n = rnd.req_meta[pos]
            if n == 0 or n < lane.num_slices:
                continue
            if rnd.overflow[s0 : s0 + n, l].any():
                continue  # the scalar replay reports the failure
            notcfc = ~CFC[s0 : s0 + n, l]
            stop = int(np.argmax(notcfc)) if notcfc.any() else n
            if ramping and (~CUR[s0 : s0 + min(stop + 1, n), l]).any():
                continue  # a rewind may fire; take the literal path
            recs = lane.chain[:stop]
            lane.accepted = recs
            lane.bandwidths = [r.bandwidth for r in recs]
            lane.corr_list = [
                _corr_flags(
                    bool(CFC[s0 + k, l]),
                    bool(FFC[s0 + k, l]),
                    bool(CUR[s0 + k, l]),
                )
                for k in range(stop)
            ]
            lane.cursor = stop
            lane.slice_i = stop
            lane.done = True

    # ---------------------------------------------------------------- replay
    def _replay(self, lane: _LaneState):
        """Advance the literal getSqrtSlices control flow against the
        lane's recorded chain. Returns None when the lane finished, or a
        (start_slice, carry_ref, ramp_until) request for the next round."""
        while lane.slice_i < lane.num_slices:
            bandwidth = (
                self.ramp_bandwidth
                if lane.ramp_until >= lane.slice_i
                else self.initial_bandwidth
            )
            rec = lane.chain[lane.cursor] if lane.cursor < len(lane.chain) else None
            pred_ok = rec is not None and (
                (lane.cursor > 0 and lane.chain[lane.cursor - 1] is lane.last)
                or (lane.cursor == 0 and self._carry_matches(rec, lane.last))
            )
            if (
                rec is None
                or rec.slice_i != lane.slice_i
                or rec.bandwidth != bandwidth
                or not pred_ok
            ):
                return (lane.slice_i, lane.last, lane.ramp_until)
            if rec.overflow:
                lane.failed = True
                return None
            lane.cursor += 1

            last_min = 0 if lane.last == "init" else lane.last.min_score
            delta = rec.min_score - last_min
            assert 0 <= delta <= WORD_SIZE, (delta, rec.slice_i)
            correctness = lane.correctness.next_state(delta, WORD_SIZE)
            rec_corr = correctness

            last_cells = 0 if lane.last == "init" else lane.last.num_cells
            if (
                lane.ramp_until == lane.slice_i
                and rec.num_cells >= BACKTRACE_OVERRIDE_CUTOFF
            ):
                lane.ramp_until += 1
            if (
                lane.ramp_until == lane.slice_i - 1
                or (
                    lane.ramp_until < lane.slice_i
                    and correctness.currently_correct()
                    and correctness.false_from_correct()
                )
            ) and last_cells < BACKTRACE_OVERRIDE_CUTOFF:
                lane.ramp = lane.last
                lane.ramp_redo_index = lane.slice_i - 1

            if not correctness.correct_from_correct():
                lane.correctness = correctness
                break
            if (
                not correctness.currently_correct()
                and lane.ramp_until < lane.slice_i
                and self.ramp_bandwidth > self.initial_bandwidth
            ):
                # rewind (literal swap quirk, GraphAligner.h:2664-2666)
                global _REWIND_COUNT
                _REWIND_COUNT += 1
                lane.ramp_until = lane.slice_i
                lane.slice_i, lane.ramp_redo_index = (
                    lane.ramp_redo_index,
                    lane.slice_i,
                )
                lane.last, lane.ramp = lane.ramp, lane.last
                del lane.bandwidths[lane.slice_i + 1 :]
                del lane.corr_list[lane.slice_i + 1 :]
                while (
                    len(lane.accepted) > 0
                    and lane.accepted[-1].slice_i > lane.slice_i
                ):
                    lane.accepted.pop()
                lane.correctness = (
                    lane.corr_list[lane.slice_i]
                    if 0 <= lane.slice_i < len(lane.corr_list)
                    else CorrectnessState()
                )
                lane.slice_i += 1
                continue

            assert len(lane.bandwidths) == lane.slice_i
            lane.bandwidths.append(bandwidth)
            lane.corr_list.append(rec_corr)
            lane.accepted.append(rec)
            lane.correctness = correctness
            lane.last = rec
            lane.slice_i += 1
        lane.done = True
        return None

    @staticmethod
    def _carry_matches(rec: _Rec, last) -> bool:
        """Is the request that produced `rec` seeded from `last`?"""
        r = rec.req_i
        if int(rec.rnd.req_start[r]) != rec.slice_i:
            return False
        if last == "init":
            return rec.slice_i == 0 and rec.rnd.carry_from[r] == "init"
        return rec.rnd.carry_from[r] is last

    def _tie_chain_inputs(self, accepted):
        """Device tie rows for one lane's accepted chain, as the native
        chain replay consumes them: tie [K, 3, Nm] int32 (plane 0 =
        subsampled band-row hash in slot 0, planes 1/2 = decoded
        node_min/node_end), check [K] uint8, min_scores [K] int32."""
        K = len(accepted)
        Nm = self.Nm
        tie = np.zeros((K, 3, Nm), np.int32)
        check = np.zeros(K, np.uint8)
        r0 = accepted[0]
        straight = all(
            rec.rnd is r0.rnd
            and rec.lane_in_round == r0.lane_in_round
            and rec.step == r0.step + k
            for k, rec in enumerate(accepted)
        )
        if straight:
            lr = r0.lane_in_round
            s0 = r0.step
            traw = r0.rnd.tie16_lane(lr)[s0 : s0 + K]
            ms = r0.rnd.min_score[s0 : s0 + K, lr].astype(np.int64)
            tie[:, 1], tie[:, 2] = _decode_tie(traw, ms[:, None])
            # subsampled band-HASH checks exist at absolute steps = 0 mod 8
            k0 = (-s0) % 8
            sub = r0.rnd.tie_ids_sub[(s0 + k0) // 8 : (s0 + K + 7) // 8, lr]
            tie[k0 : k0 + sub.shape[0] * 8 : 8, 0, 0] = sub
            check[k0::8] = 1
            ms = ms.astype(np.int32)
        else:
            ms = np.zeros(K, np.int32)
            for k, rec in enumerate(accepted):
                traw = rec.rnd.tie16_lane(rec.lane_in_round)[rec.step]
                tie[k, 1], tie[k, 2] = _decode_tie(traw, rec.min_score)
                ms[k] = rec.min_score
                if rec.step % 8 == 0:
                    tie[k, 0, 0] = rec.rnd.tie_ids_sub[
                        rec.step // 8, rec.lane_in_round
                    ]
                    check[k] = 1
        return tie, check, ms


# =========================================================================
# Batched seed-and-extend orchestration (reference AlignOneWay seeded,
# GraphAligner.h:408-491): one seed per read per wave, so the sequential
# "skip seeds inside already-aligned regions" rule (420-429) is preserved
# exactly while all reads' DP extensions run batched on the device.
# =========================================================================


def seed_extension_problems(graph: AlignmentGraph, sequence: str, seed):
    """The two extension problems one seed spawns (reference
    getSplitAlignment, GraphAligner.h:2969-3024): the RC'd backward
    prefix (seeded at the opposite-orientation node, extended by
    dbg_overlap) and the forward suffix. Returns (bw, fw), each a
    (padded_sequence, start_node_index) pair or None when that side is
    empty."""
    from ..io.sequences import reverse_complement

    node_id, pos, reverse = seed
    if reverse:
        fw_node = graph.node_lookup[node_id * 2 + 1]
        bw_node = graph.node_lookup[node_id * 2]
    else:
        fw_node = graph.node_lookup[node_id * 2]
        bw_node = graph.node_lookup[node_id * 2 + 1]
    bw = fw = None
    if pos > 0:
        bw = (
            _pad_to_word(
                reverse_complement(sequence[: pos + graph.dbg_overlap])
            ),
            bw_node,
        )
    if pos < len(sequence) - 1:
        fw = (_pad_to_word(sequence[pos:]), fw_node)
    return bw, fw


def align_reads_seeded_batch(
    graph: AlignmentGraph,
    aligner: BandedBatchAligner,
    reads,
    seed_map: dict,
    logger=None,
):
    """reads: [FastQ]; seed_map: seq_id -> [(node_id, pos, reverse)].
    Returns {seq_id: AlignmentResult} identical to align_one_way_seeded.
    Each wave entry is assembled as soon as both of its extension pieces
    have walked; a read with no seeds left is finalized immediately."""
    import time as _time

    from . import trace_ops
    from .align import (
        get_piecewise_traces_from_split,
        get_split_alignment,
        get_trace_info,
    )
    from .result import (
        AlignmentResult,
        LazyAlignment,
        LazyTrace,
        empty_alignment,
    )

    def as_arr(t):
        return np.asarray(t, dtype=np.int64).reshape(-1, 2)

    INT_MAX = 2**62
    # native per-piece trace finalize (ga_trace_piece2)
    tp_ctx = native.TracePieceCtx(
        np.ascontiguousarray(aligner.rev_pos, dtype=np.int64),
        np.ascontiguousarray(graph.pos_to_node),
        np.ascontiguousarray(graph.node_start, dtype=np.int64),
        np.ascontiguousarray(graph.node_ids, dtype=np.int64),
        np.ascontiguousarray(graph.reverse.astype(np.uint8)),
        graph.dummy_node_start,
        graph.dummy_node_end,
    )

    t0 = _time.time()
    state = {}
    results: dict = {}
    for r in reads:
        state[r.seq_id] = {
            "read": r,
            "seeds": seed_map.get(r.seq_id, []),
            "cursor": 0,
            "tried": [],
            "best": None,  # (estimated, trace, seed, runs)
        }

    def process_entry(s, seed, fw_i, bw_i, walked):
        """Assemble one wave entry (reference getPiecewiseTracesFromSplit,
        GraphAligner.h:3040-3098) and fold it into the read's best."""
        global _HOST_FALLBACKS
        native.set_read(s["read"].seq_id)
        node_id, pos, reverse = seed
        sequence = s["read"].sequence
        cells = 0
        fb_needed = (fw_i is not None and walked[fw_i] is None) or (
            bw_i is not None and walked[bw_i] is None
        )
        if fb_needed and _os.environ.get("GA_NO_FALLBACK") == "1":
            raise RuntimeError(
                f"GA_NO_FALLBACK: read {s['read'].seq_id!r} seed {seed} "
                "fell back to the host oracle"
            )
        if fb_needed:
            _HOST_FALLBACKS += 1
            split = get_split_alignment(
                graph,
                sequence,
                node_id,
                reverse,
                pos,
                aligner.initial_bandwidth,
                aligner.ramp_bandwidth,
            )
            (f_sc, f_tr), (b_sc, b_tr) = get_piecewise_traces_from_split(
                graph, split, sequence
            )
            trace = ((f_sc, as_arr(f_tr)), (b_sc, as_arr(b_tr)))
            est = split.estimated_correctly_aligned()
            runs_pair = None  # finalize derives runs via trace_to_runs
            s["cells"] = s.get("cells", 0) + cells
            trace_ops.add_alignment_nodes(graph, s["tried"], trace)
        else:
            fw = (0, np.zeros((0, 2), np.int64))
            bw = (0, np.zeros((0, 2), np.int64))
            fw_runs = bw_runs = None
            keep_fw = keep_bw = 0
            bw_tried: list = []
            fw_tried: list = []
            if bw_i is not None:
                b_score, b_trace, keep_bw, b_cells = walked[bw_i]
                cells += b_cells
                if keep_bw > 0:
                    b_final, bw_runs, bw_tried = tp_ctx.piece(
                        b_trace, pos, True, pos - 1, 0
                    )
                    bw = (b_score, b_final)
            if fw_i is not None:
                f_score, f_trace, keep_fw, f_cells = walked[fw_i]
                cells += f_cells
                if keep_fw > 0:
                    backtraceable = len(sequence) - pos - graph.dbg_overlap
                    f_final, fw_runs, fw_tried = tp_ctx.piece(
                        f_trace, backtraceable, False, 0,
                        pos if keep_bw > 0 else 0,
                    )
                    fw = (f_score, f_final)
            trace = (fw, bw)
            est = (keep_fw + keep_bw) * WORD_SIZE
            runs_pair = (fw_runs, bw_runs)
            s["cells"] = s.get("cells", 0) + cells
            s["tried"].extend(fw_tried)
            s["tried"].extend(bw_tried)
        if s["best"] is None or est > s["best"][0]:
            s["best"] = (est, trace, seed, runs_pair)

    def finalize_read(seq_id, s):
        """The tail of align_one_way_seeded for one read."""
        elapsed = int((_time.time() - t0) * 1000)
        if s["best"] is None:
            return empty_alignment(elapsed, 0)
        est, trace, best_seed, runs_pair = s["best"]
        sequence = s["read"].sequence
        (fw_score, fw_trace), (bw_score, bw_trace) = trace
        if fw_score >= INT_MAX and bw_score >= INT_MAX:
            return empty_alignment(elapsed, 0)
        trace_vector = LazyTrace(
            lambda g=graph, sq=sequence, b=bw_trace, f=fw_trace: get_trace_info(
                g, sq, [tuple(x) for x in b], [tuple(x) for x in f]
            )
        )
        if runs_pair is not None:
            fw_runs, bw_runs = runs_pair
        else:
            fw_runs = trace_ops.trace_to_runs(graph, fw_trace)
            bw_runs = trace_ops.trace_to_runs(graph, bw_trace)
        if fw_runs is None and bw_runs is None:
            return empty_alignment(elapsed, 0)
        score = (bw_score if bw_runs is not None else 0) + (
            fw_score if fw_runs is not None else 0
        )
        runs = trace_ops.merge_runs(graph, bw_runs, fw_runs)
        last_aligned = int(bw_trace[0][1]) if len(bw_trace) else best_seed[1]
        result = AlignmentResult(
            alignment=LazyAlignment(
                graph, seq_id, sequence, score, last_aligned, runs
            ),
            alignment_failed=False,
            cells_processed=s.get("cells", 0),
            elapsed_milliseconds=elapsed,
        )
        result.trace = trace_vector
        result.alignment_start = last_aligned
        result.alignment_end = result.alignment_start + est
        return result

    active = [s for s in state.values() if s["seeds"]]
    while active:
        wave = []  # (state, seed, fw_problem_idx|None, bw_problem_idx|None)
        problems = []
        for s in active:
            seed = None
            while s["cursor"] < len(s["seeds"]):
                node_id, pos, reverse = s["seeds"][s["cursor"]]
                s["cursor"] += 1
                node_index = graph.node_lookup[node_id * 2]
                if any(
                    lo <= pos <= hi and n == node_index
                    for (lo, hi, n) in s["tried"]
                ):
                    if logger:
                        logger(f"seed {s['cursor'] - 1} already aligned")
                    continue
                seed = (node_id, pos, reverse)
                break
            if seed is None:
                continue
            bw, fw = seed_extension_problems(graph, s["read"].sequence, seed)
            fw_i = bw_i = None
            if bw is not None:
                bw_i = len(problems)
                problems.append(bw)
            if fw is not None:
                fw_i = len(problems)
                problems.append(fw)
            wave.append((s, seed, fw_i, bw_i))

        if not wave:
            break
        walked: dict = {}
        done_entries = [False] * len(wave)
        for batch in aligner.get_traces_stream(problems):
            walked.update(batch)
            for wi, (s, seed, fw_i, bw_i) in enumerate(wave):
                if done_entries[wi]:
                    continue
                need = [x for x in (fw_i, bw_i) if x is not None]
                if not all(x in walked for x in need):
                    continue
                done_entries[wi] = True
                process_entry(s, seed, fw_i, bw_i, walked)
                if s["cursor"] >= len(s["seeds"]):
                    sid = s["read"].seq_id
                    results[sid] = finalize_read(sid, s)
        assert all(done_entries)
        active = [s for s in active if s["cursor"] < len(s["seeds"])]

    for seq_id, s in state.items():
        if seq_id not in results:
            results[seq_id] = finalize_read(seq_id, s)
    return results
