"""Exhaustive-mode (-i) batched alignment engine, torch port.

Port of ``graphaligner_tpu/core/engine.py``: every graph position is active
in every slice (banded semantics with unbounded bandwidth), so the
alignments are optimal. The positions are swept in the topological order
of the SCC condensation (``build_schedule``); the DP of every slice runs as
kernel K3 (``ops.exhaustive``): a slice wavefront on acyclic graphs, and
a kernel that iterates cyclic graphs to their fixpoint node by node. The
packed slabs come back to the host, where ``DeviceSliceView`` unpacks node
columns lazily for the unchanged host backtrace.

The JAX package picks between an XLA wavefront and an XLA column scan
here; both give the same slabs as K3, so the port runs K3 alone.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .._device import get_device
from ..graph.alignment_graph import AlignmentGraph
from ..io.sequences import IUPAC_MATCHES
from ..ops.exhaustive import WAVE_WARPS, exhaustive
from ..ops.packing import unpack_deltas_np
from .hmm import CorrectnessState
from .oracle import _banded_tarjan, make_initial_slice_full_band
from .params import WORD_SIZE

INF = np.int32(1 << 30)

# read-character alphabet for device match tables
_READ_ALPHABET = "ACGTRYSWKMBDHVN"
_READ_CODE = {c: i for i, c in enumerate(_READ_ALPHABET)}
# match table [read code, graph code(5)] — graph code 4 = dummy, never matches
_MATCH_TABLE = np.zeros((len(_READ_ALPHABET), 5), dtype=bool)
for _c, _i in _READ_CODE.items():
    for _g, _base in enumerate("ATCG"):
        _MATCH_TABLE[_i, _g] = _base in IUPAC_MATCHES[_c]


_ENCODE_LUT = np.full(256, 255, dtype=np.uint8)
for _c, _i in _READ_CODE.items():
    _ENCODE_LUT[ord(_c)] = _i
    _ENCODE_LUT[ord(_c.lower())] = _i


def encode_read(sequence: str) -> np.ndarray:
    codes = _ENCODE_LUT[np.frombuffer(sequence.encode("latin-1"), np.uint8)]
    if codes.max(initial=0) == 255:
        bad = sequence[int(np.argmax(codes == 255))]
        raise ValueError(f"unsupported read character {bad!r}")
    return codes


# copied from graphaligner_tpu/ops/pallas/exhaustive.py:42-57 --------------
def _build_eq_vectors(read_codes: np.ndarray, match_table: np.ndarray, num_slices: int):
    """Per-slice per-graph-code Eq bitvectors (reference BA/BT/BC/BG,
    GraphAligner.h:2337-2351), host-side.

    read_codes [B, S*64] uint8 → eq [S, 5, 2, B] uint32 (lo, hi)."""
    B = read_codes.shape[0]
    eq = np.zeros((num_slices, 5, 2, B), dtype=np.uint32)
    # match_rows [B, S*64, 5]
    match_rows = match_table[read_codes]
    for s in range(num_slices):
        rows = match_rows[:, s * WORD_SIZE : (s + 1) * WORD_SIZE, :]  # [B,64,5]
        bits_lo = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint32)
        for c in range(5):
            eq[s, c, 0] = (rows[:, :32, c] * bits_lo).sum(axis=1, dtype=np.uint32)
            eq[s, c, 1] = (rows[:, 32:, c] * bits_lo).sum(axis=1, dtype=np.uint32)
    return eq


# --------------------------------------------------------------------------
def host_free_bytes() -> int:
    """Physical memory the host has free now."""
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


@dataclass
class DeviceSchedule:
    """Topologically-ordered column schedule + device graph arrays."""

    graph: AlignmentGraph
    cell_pos: np.ndarray  # [P] graph position per step
    code: np.ndarray  # [P] uint8 base code
    is_start: np.ndarray  # [P] bool
    is_source_start: np.ndarray  # [P] bool (node start with no in-edges)
    pred_nodes: np.ndarray  # [P, max_indeg] node slot of in-neighbors (-1 pad)
    node_slot: np.ndarray  # [P] node index
    pos_to_step: np.ndarray  # [graph bp] inverse of cell_pos
    num_nodes: int
    cyclic: bool = False
    node_order: list | None = None  # nodes in schedule order (shared, read-only)


def build_schedule(graph: AlignmentGraph) -> DeviceSchedule:
    """Column schedule in SCC-condensation topological order. For
    cyclic graphs the order within a cyclic component is arbitrary;
    K3 then iterates whole-slice passes to the Bellman-Ford fixpoint
    (the reference's UniqueQueue recalculation loop for cyclic
    components, GraphAligner.h calculateSlice)."""
    order = [int(n) for n in graph.topo_node_order]
    cell_pos = []
    code = []
    is_start = []
    is_source_start = []
    pred_nodes = []
    node_slot = []
    max_indeg = max(1, int(np.diff(graph.in_ptr).max()))
    for n in order:
        start, end = int(graph.node_start[n]), int(graph.node_end[n])
        preds = [int(x) for x in graph.in_neighbors(n)]
        for w in range(start, end):
            cell_pos.append(w)
            code.append(int(graph.seq_codes[w]))
            first = w == start
            is_start.append(first)
            is_source_start.append(first and not preds)
            row = preds + [-1] * (max_indeg - len(preds)) if first else [-1] * max_indeg
            pred_nodes.append(row)
            node_slot.append(n)
    cell_pos = np.array(cell_pos, dtype=np.int32)
    pos_to_step = np.empty(graph.size_in_bp, dtype=np.int32)
    pos_to_step[cell_pos] = np.arange(len(cell_pos), dtype=np.int32)
    return DeviceSchedule(
        graph=graph,
        cell_pos=cell_pos,
        code=np.array(code, dtype=np.int32),
        is_start=np.array(is_start, dtype=bool),
        is_source_start=np.array(is_source_start, dtype=bool),
        pred_nodes=np.array(pred_nodes, dtype=np.int32),
        node_slot=np.array(node_slot, dtype=np.int32),
        pos_to_step=pos_to_step,
        num_nodes=graph.node_count,
        cyclic=bool(graph.comp_cyclic.any()),
        node_order=order,
    )


class DeviceSliceView:
    """SliceScores-compatible view of one read's slice in the packed host
    slabs (``slabs``: vp_lo, vp_hi, vn_lo, vn_hi, sbs, score_end, each
    [S, P, B]); reconstructs score columns lazily for the host backtrace.
    ``node_min`` is indexed by node: the minimum last-row score of each
    node in this slice."""

    def __init__(self, sched: DeviceSchedule, j, slabs, s, b, node_min):
        self._sched = sched
        self.j = j
        self._slabs = slabs
        self._sb = (s, b)
        self._cache: dict = {}
        self.nodes = sched.node_order
        self.correctness = CorrectnessState()
        self.min_score = 0
        self.min_score_index: list = []
        self.node_min = node_min
        self.num_cells = slabs[4].shape[1]

    def score_end(self, steps) -> np.ndarray:
        """Last-row scores at schedule ``steps``."""
        s, b = self._sb
        return self._slabs[5][s, steps, b]

    def _rows(self, node: int) -> np.ndarray:
        cached = self._cache.get(node)
        if cached is not None:
            return cached
        g = self._sched.graph
        steps = self._sched.pos_to_step[int(g.node_start[node]) : int(g.node_end[node])]
        s, b = self._sb
        vp_lo, vp_hi, vn_lo, vn_hi, sbs = (x[s, steps, b] for x in self._slabs[:5])
        scores = unpack_deltas_np(vp_lo, vp_hi, vn_lo, vn_hi, sbs.astype(np.int64))
        rows = scores.T  # [64, L]
        self._cache[node] = rows
        return rows

    # SliceScores protocol used by the backtrace/band/pipeline code
    def has_node(self, node: int) -> bool:
        return True

    def get_value(self, graph, row: int, pos: int) -> int:
        node = graph.index_to_node(pos)
        return int(self._rows(node)[row, pos - graph.node_start[node]])

    def get_value_or_max(self, graph, row: int, pos: int, default):
        return self.get_value(graph, row, pos)

    def node_end_score(self, node: int) -> int:
        return int(self._rows(node)[WORD_SIZE - 1, -1])

    @property
    def rows(self):  # for SliceScores duck-typing in min-index collection
        raise AttributeError("use _rows(node)")


class BatchAligner:
    """Aligns batches of reads in exhaustive mode on ``device`` ("cuda"
    runs K3, "cpu" its plain version) and produces host-side DPTables
    compatible with the existing backtrace and GAM conversion."""

    def __init__(self, graph: AlignmentGraph, device="cuda"):
        self.graph = graph
        self.device = get_device(device)
        sched = self.sched = build_schedule(graph)

        def t(a):
            return torch.as_tensor(
                np.ascontiguousarray(a, dtype=np.int32), device=self.device
            )

        self._dev_sched = (
            t(sched.code), t(sched.is_start), t(sched.is_source_start),
            t(sched.pred_nodes), t(sched.node_slot),
        )
        order = np.asarray(sched.node_order, dtype=np.int64)
        lens = np.asarray(graph.node_len, dtype=np.int64)[order]
        if (lens < 1).any():
            raise ValueError("every graph node needs at least one base")
        # the schedule holds each node's positions contiguously, in
        # topological node order: the first step of each node
        self._node_first = np.concatenate([[0], np.cumsum(lens)[:-1]])
        self._node_order = order
        # _finalize_table's search order for the slice minimum: components
        # reversed (sources last), nodes reversed within a component, each
        # node's positions ascending (the reference's band iteration)
        band_order = sched.node_order
        components = _banded_tarjan(graph, band_order, dict.fromkeys(band_order, True))
        nodes = [n for comp in reversed(components) for n in reversed(comp)]
        pos = np.concatenate([
            np.arange(int(graph.node_start[n]), int(graph.node_end[n]))
            for n in nodes
        ])
        self.min_order_pos = pos
        self.min_order_steps = sched.pos_to_step[pos]
        self.initial_slice = make_initial_slice_full_band(graph)

    def lanes_that_fit(self, num_slices: int, cap: int) -> int:
        """Most lanes (at least 1, at most ``cap``) of ``num_slices`` slices
        whose ``compute_tables`` fits in half the free memory. A lane takes
        the six int32 slabs (24 * S * P bytes) on the device, with its Eq
        words and the node store (24 * N bytes for each slice-warp of the
        wavefront, at most ``WAVE_WARPS``; once for the cyclic route, which
        keeps it in shared memory instead where it fits: an upper bound
        there; its node tables, kept for the schedule, and its pass log are
        not per lane),
        and again on the host, with the per-node minima, its read codes and
        Eq words. On the CPU both live in host memory, beside the plain
        version's int64 slabs and store."""
        S, P, N = num_slices, len(self.sched.code), self.sched.num_nodes
        slabs = 24 * S * P
        stores = 1 if self.sched.cyclic else min(S, WAVE_WARPS)
        on_host = slabs + 8 * S * N + 104 * S
        on_device = slabs + 24 * stores * N + 40 * S
        if self.device.type == "cuda":
            free = torch.cuda.mem_get_info(self.device)[0]
            fit = min(free // (2 * on_device), host_free_bytes() // (2 * on_host))
        else:
            need = on_host + on_device + 2 * slabs + 48 * N
            fit = host_free_bytes() // (2 * need)
        return int(max(1, min(cap, fit)))

    def compute_tables(self, sequences: list, num_slices: int | None = None):
        """Returns per-read lists of DeviceSliceView (slice 0..S_b-1)."""
        B = len(sequences)
        slices_per_read = [
            (len(s) + WORD_SIZE - 1) // WORD_SIZE for s in sequences
        ]
        S = num_slices or max(slices_per_read)
        codes = np.full((B, S * WORD_SIZE), _READ_CODE["N"], dtype=np.uint8)
        for i, s in enumerate(sequences):
            codes[i, : len(s)] = encode_read(s)
        eq = _build_eq_vectors(codes, _MATCH_TABLE, S).view(np.int32)
        *slabs, nonconv = exhaustive(
            torch.as_tensor(eq, device=self.device),
            *self._dev_sched,
            num_nodes=self.sched.num_nodes,
            cyclic=self.sched.cyclic,
        )
        if bool(nonconv.any()):
            raise ValueError(
                "cyclic fixpoint did not converge within the pass cap"
            )
        host = [x.cpu().numpy() for x in slabs]  # each [S, P, B]
        for k in range(4):
            host[k] = host[k].view(np.uint32)
        # per-node minimum of the last-row scores, every slice and lane
        node_min = np.empty((S, self.sched.num_nodes, B), dtype=np.int64)
        node_min[:, self._node_order] = np.minimum.reduceat(
            host[5], self._node_first, axis=1
        )
        return [
            [
                DeviceSliceView(self.sched, s * WORD_SIZE, host, s, b,
                                node_min[s, :, b])
                for s in range(slices_per_read[b])
            ]
            for b in range(B)
        ]


def _finalize_table(ba: BatchAligner, views: list):
    """Attach reference-order min scores/indices and HMM states, build a
    DPTable through the existing pipeline types. The minimum index lists
    every position whose last-row score is the slice minimum, in the
    band's reversed-component order (``BatchAligner.min_order_*``)."""
    from .align import DPTable

    table = DPTable(slices=[ba.initial_slice])
    correctness = CorrectnessState()
    prev_min = 0
    for view in views:
        ends = view.score_end(ba.min_order_steps)
        min_score = int(ends.min())
        view.min_score = min_score
        view.min_score_index = ba.min_order_pos[ends == min_score].tolist()
        delta = min(WORD_SIZE, view.min_score - prev_min)
        correctness = correctness.next_state(delta, WORD_SIZE)
        view.correctness = correctness
        prev_min = view.min_score
        table.slices.append(view)
        table.bandwidth_per_slice.append(0)
        table.correctness.append(correctness)
    return table


def align_batch_full_band(graph: AlignmentGraph, reads: list, batch_aligner=None,
                          device="cuda"):
    """Exhaustive-mode batched alignment: returns per-read AlignmentResult.

    Pipeline parity notes: band projection is bypassed (all positions
    active — optimal alignments); the HMM still trims wrongly-aligned
    tails as in the reference."""
    from .align import remove_wrongly_aligned_end, trace_to_alignment, _pad_to_word
    from .backtrace import get_trace_from_table
    from .result import empty_alignment

    ba = batch_aligner or BatchAligner(graph, device)
    sequences = [r.sequence for r in reads]
    tables_views = ba.compute_tables(sequences)
    results = []
    for read, views in zip(reads, tables_views):
        table = _finalize_table(ba, views)
        remove_wrongly_aligned_end(table)
        padded = _pad_to_word(read.sequence)
        padding = len(padded) - len(read.sequence)
        score, trace = get_trace_from_table(graph, padded, table)
        if score >= INF or not trace:
            results.append(empty_alignment(0, 0))
            continue
        while trace and trace[-1][1] >= len(padded) - padding:
            trace.pop()
        result = trace_to_alignment(graph, read.seq_id, read.sequence, score, trace, 0)
        result.alignment_start = trace[0][1]
        result.alignment_end = trace[-1][1]
        results.append(result)
    return results
