# Frozen copy of graphaligner_tpu_torch/core/align.py, part of the benchmark's plain reference (imports nothing of the program).
"""Alignment orchestration: slice tables, ramping, seeds, trace → GAM.

Replicates the reference's pipeline (GraphAligner.h):
  get_table            ≡ getSqrtSlices (2571-2856) — every slice stored,
                         so the sqrt-sampling/recompute machinery and
                         BacktraceOverride windows (memory optimizations,
                         not value changes) are unnecessary host-side
  remove_wrongly_aligned_end ≡ 2554-2569
  align_one_way_seeded ≡ AlignOneWay (408-491), getSplitAlignment
                         (2969-3024), getPiecewiseTracesFromSplit
                         (3026-3098), getBacktraceFullStart (3100-3133)
  trace_to_alignment   ≡ traceToAlignment (782-847)
  merge_alignments     ≡ mergeAlignments (648-688)

The slice computation is the scalar oracle (``oracle.compute_slice``).
``align_one_way_seeded`` also counts the band cells of every kept slice
(the reference's cellsProcessed), which the program reports per read.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field

from .graph import AlignmentGraph
from . import vg
from .sequences import reverse_complement
from .backtrace import get_trace_from_table
from .band import project_forward_from_min_score
from .oracle import (
    SliceScores,
    compute_slice,
    make_initial_slice_one_node,
)
from .params import BACKTRACE_OVERRIDE_CUTOFF, WORD_SIZE
from .result import (
    INT32_MAX,
    AlignmentResult,
    empty_alignment,
)

INT_MAX = 2**62


@dataclass
class DPTable:
    slices: list = field(default_factory=list)  # [0] = initial slice
    bandwidth_per_slice: list = field(default_factory=list)
    correctness: list = field(default_factory=list)


def get_table(
    graph: AlignmentGraph,
    sequence: str,
    initial_slice: SliceScores,
    num_slices: int,
    initial_bandwidth: int,
    ramp_bandwidth: int,
    slice_backend=compute_slice,
) -> DPTable:
    """The outer DP loop over 64-row slices with bandwidth ramping
    (reference getSqrtSlices, GraphAligner.h:2571-2856; the quirky
    slice/rampRedoIndex swap at 2664-2666 is replicated literally)."""
    table = DPTable(slices=[initial_slice])
    last_slice = initial_slice
    ramp_slice = initial_slice
    ramp_redo_index = -1
    ramp_until = 0
    slice_i = 0
    while slice_i < num_slices:
        bandwidth = ramp_bandwidth if ramp_until >= slice_i else initial_bandwidth
        band = project_forward_from_min_score(graph, last_slice, bandwidth)
        new_slice = slice_backend(
            graph, sequence, slice_i * WORD_SIZE, band, last_slice, slice_i, bandwidth
        )
        delta = new_slice.min_score - last_slice.min_score
        assert 0 <= delta <= WORD_SIZE
        new_slice.correctness = last_slice.correctness.next_state(delta, WORD_SIZE)

        if ramp_until == slice_i and new_slice.num_cells >= BACKTRACE_OVERRIDE_CUTOFF:
            ramp_until += 1
        if (
            ramp_until == slice_i - 1
            or (
                ramp_until < slice_i
                and new_slice.correctness.currently_correct()
                and new_slice.correctness.false_from_correct()
            )
        ) and last_slice.num_cells < BACKTRACE_OVERRIDE_CUTOFF:
            ramp_slice = last_slice
            ramp_redo_index = slice_i - 1

        if not new_slice.correctness.correct_from_correct():
            break
        if (
            not new_slice.correctness.currently_correct()
            and ramp_until < slice_i
            and ramp_bandwidth > initial_bandwidth
        ):
            # rewind to the ramp slice and redo with the ramp bandwidth
            ramp_until = slice_i
            slice_i, ramp_redo_index = ramp_redo_index, slice_i
            last_slice, ramp_slice = ramp_slice, last_slice
            del table.bandwidth_per_slice[slice_i + 1 :]
            del table.correctness[slice_i + 1 :]
            while len(table.slices) > 1 and table.slices[-1].j > slice_i * WORD_SIZE:
                table.slices.pop()
            slice_i += 1
            continue

        assert len(table.bandwidth_per_slice) == slice_i
        table.bandwidth_per_slice.append(bandwidth)
        table.correctness.append(new_slice.correctness)
        table.slices.append(new_slice)
        last_slice = new_slice
        slice_i += 1
    return table


def remove_wrongly_aligned_end(table: DPTable) -> None:
    """Trim trailing slices the HMM deems wrongly aligned
    (reference removeWronglyAlignedEnd, GraphAligner.h:2554-2569)."""
    currently_correct = (
        table.correctness[-1].currently_correct() if table.correctness else False
    )
    while not currently_correct:
        if not table.correctness:
            break
        table.correctness.pop()
        table.bandwidth_per_slice.pop()
        if not table.correctness:
            break
        currently_correct = table.correctness[-1].false_from_correct()
    if not table.correctness:
        table.slices.clear()
    while (
        len(table.slices) > 1
        and table.slices[-1].j >= len(table.correctness) * WORD_SIZE
    ):
        table.slices.pop()


def _pad_to_word(seq: str) -> str:
    padding = (WORD_SIZE - (len(seq) % WORD_SIZE)) % WORD_SIZE
    return seq + "N" * padding


@dataclass
class TwoDirectionalSplit:
    sequence_split_index: int = 0
    forward: DPTable = field(default_factory=DPTable)
    backward: DPTable = field(default_factory=DPTable)

    def estimated_correctly_aligned(self) -> int:
        return (
            len(self.forward.bandwidth_per_slice)
            + len(self.backward.bandwidth_per_slice)
        ) * WORD_SIZE


def get_split_alignment(
    graph: AlignmentGraph,
    sequence: str,
    bigraph_node_id: int,
    backwards: bool,
    seq_pos: int,
    initial_bandwidth: int,
    ramp_bandwidth: int,
    slice_backend=compute_slice,
) -> TwoDirectionalSplit:
    """Align the RC'd prefix backward and the suffix forward from the seed
    node (reference getSplitAlignment, GraphAligner.h:2969-3024)."""
    if backwards:
        forward_node = graph.node_lookup[bigraph_node_id * 2 + 1]
        backward_node = graph.node_lookup[bigraph_node_id * 2]
    else:
        forward_node = graph.node_lookup[bigraph_node_id * 2]
        backward_node = graph.node_lookup[bigraph_node_id * 2 + 1]
    result = TwoDirectionalSplit(sequence_split_index=seq_pos)
    if seq_pos > 0:
        backward_part = _pad_to_word(
            reverse_complement(sequence[: seq_pos + graph.dbg_overlap])
        )
        initial = make_initial_slice_one_node(graph, backward_node)
        table = get_table(
            graph,
            backward_part,
            initial,
            len(backward_part) // WORD_SIZE,
            initial_bandwidth,
            ramp_bandwidth,
            slice_backend,
        )
        remove_wrongly_aligned_end(table)
        result.backward = table
    if seq_pos < len(sequence) - 1:
        forward_part = _pad_to_word(sequence[seq_pos:])
        initial = make_initial_slice_one_node(graph, forward_node)
        table = get_table(
            graph,
            forward_part,
            initial,
            len(forward_part) // WORD_SIZE,
            initial_bandwidth,
            ramp_bandwidth,
            slice_backend,
        )
        remove_wrongly_aligned_end(table)
        result.forward = table
    return result


def _reverse_trace(graph: AlignmentGraph, trace: list, end: int) -> list:
    """Map a backward trace to forward coordinates
    (reference reverseTrace, GraphAligner.h:3026-3038)."""
    if not trace:
        return trace
    out = []
    for w, r in reversed(trace):
        out.append((graph.get_reverse_position(w), end - r))
    return out


def get_piecewise_traces_from_split(
    graph: AlignmentGraph, split: TwoDirectionalSplit, sequence: str
) -> tuple:
    """(forward (score, trace), backward (score, trace)) in full-read
    coordinates (reference getPiecewiseTracesFromSplit, 3040-3098).
    Note: the forward trace is shifted by the split index only when a
    backward part exists — a reference quirk replicated for parity."""
    fw = (0, [])
    bw = (0, [])
    split_idx = split.sequence_split_index
    if split_idx < len(sequence) - 1 and split.forward.slices:
        backtraceable = len(sequence) - split_idx - graph.dbg_overlap
        fw_seq = _pad_to_word(sequence[split_idx:])
        score, trace = get_trace_from_table(graph, fw_seq, split.forward)
        while trace and trace[-1][1] >= backtraceable:
            trace.pop()
        fw = (score, trace)
    if split_idx > 0 and split.backward.slices:
        bw_seq = _pad_to_word(
            reverse_complement(sequence[: split_idx + graph.dbg_overlap])
        )
        score, trace = get_trace_from_table(graph, bw_seq, split.backward)
        while trace and trace[-1][1] >= split_idx:
            trace.pop()
        trace = _reverse_trace(graph, trace, split_idx - 1)
        bw = (score, trace)
        fw = (fw[0], [(w, r + split_idx) for (w, r) in fw[1]])
    return fw, bw


def trace_to_alignment(
    graph: AlignmentGraph,
    seq_id: str,
    sequence: str,
    score: int,
    trace: list,
    cells_processed: int,
) -> AlignmentResult:
    """MatrixPosition path → vg Alignment with per-node Mappings/Edits
    (reference traceToAlignment, GraphAligner.h:782-847, including the
    missing +1 on the final edit's from_length)."""
    aln = vg.Alignment(name=seq_id, score=score, sequence=sequence, path=vg.Path())
    if not trace:
        return AlignmentResult(aln, True, cells_processed, INT_MAX)
    pos = 0
    old_node = graph.index_to_node(trace[0][0])
    while old_node == graph.dummy_node_start:
        pos += 1
        if pos == len(trace):
            return empty_alignment(INT_MAX, cells_processed)
        old_node = graph.index_to_node(trace[pos][0])
    if old_node == graph.dummy_node_end:
        return empty_alignment(INT_MAX, cells_processed)
    rank = 0
    mapping = vg.Mapping(
        position=vg.Position(
            node_id=int(graph.node_ids[old_node]),
            is_reverse=bool(graph.reverse[old_node]),
            offset=int(trace[pos][0] - graph.node_start[old_node]),
        ),
        rank=rank,
    )
    aln.path.mapping.append(mapping)
    bt_node_start = trace[pos]
    bt_node_end = trace[pos]
    bt_before_node = trace[pos]
    while pos < len(trace):
        cur_node = graph.index_to_node(trace[pos][0])
        if cur_node == graph.dummy_node_end:
            break
        if cur_node == old_node:
            bt_node_end = trace[pos]
            pos += 1
            continue
        mapping.edit.append(
            vg.Edit(
                from_length=bt_node_end[0] - bt_node_start[0] + 1,
                to_length=bt_node_end[1] - bt_before_node[1],
                sequence=sequence[
                    bt_node_start[1] : bt_node_start[1]
                    + (bt_node_end[1] - bt_before_node[1])
                ],
            )
        )
        old_node = cur_node
        bt_before_node = bt_node_end
        bt_node_start = trace[pos]
        bt_node_end = trace[pos]
        rank += 1
        mapping = vg.Mapping(
            position=vg.Position(
                node_id=int(graph.node_ids[old_node]),
                is_reverse=bool(graph.reverse[old_node]),
            ),
            rank=rank,
        )
        aln.path.mapping.append(mapping)
        pos += 1
    mapping.edit.append(
        vg.Edit(
            from_length=bt_node_end[0] - bt_node_start[0],
            to_length=bt_node_end[1] - bt_before_node[1],
            sequence=sequence[
                bt_node_start[1] : bt_node_start[1]
                + (bt_node_end[1] - bt_before_node[1])
            ],
        )
    )
    return AlignmentResult(aln, False, cells_processed, INT_MAX)


def merge_alignments(
    graph: AlignmentGraph, first: AlignmentResult, second: AlignmentResult
) -> AlignmentResult:
    """Concatenate backward+forward piece alignments
    (reference mergeAlignments, GraphAligner.h:648-688)."""
    assert not first.alignment_failed or not second.alignment_failed
    if first.alignment_failed:
        return second
    if second.alignment_failed:
        return first
    if not first.alignment.path.mapping:
        return second
    if not second.alignment.path.mapping:
        return first
    fa = first.alignment
    # shallow merge: a fresh Alignment/Path with a fresh mapping LIST
    # (shared Mapping objects — both pieces are discarded by callers);
    # the old decode(encode()) deep copy cost ~2ms per long read
    merged = vg.Alignment(
        sequence=fa.sequence,
        name=fa.name,
        quality=fa.quality,
        mapping_quality=fa.mapping_quality,
        score=fa.score + second.alignment.score,
        query_position=fa.query_position,
        path=vg.Path(
            name=fa.path.name,
            mapping=list(fa.path.mapping),
            is_circular=fa.path.is_circular,
            length=fa.path.length,
        ),
    )
    result = AlignmentResult(
        alignment=merged,
        alignment_failed=False,
        cells_processed=first.cells_processed + second.cells_processed,
        elapsed_milliseconds=first.elapsed_milliseconds + second.elapsed_milliseconds,
    )
    start = 0
    first_end = first.alignment.path.mapping[-1].position
    second_start = second.alignment.path.mapping[0].position
    first_node = graph.node_lookup.get(first_end.node_id)
    second_node = graph.node_lookup.get(second_start.node_id)
    if (
        first_end.node_id == second_start.node_id
        and first_end.is_reverse == second_start.is_reverse
    ):
        start = 1
    elif first_node is not None and second_node is not None and second_node in set(
        int(x) for x in graph.out_neighbors(first_node)
    ):
        start = 0
    for m in second.alignment.path.mapping[start:]:
        result.alignment.path.mapping.append(m)
    return result


def align_one_way_seeded(
    graph: AlignmentGraph,
    seq_id: str,
    sequence: str,
    initial_bandwidth: int,
    ramp_bandwidth: int,
    seed_hits: list,
    slice_backend=compute_slice,
    logger=None,
) -> AlignmentResult:
    """Seed-and-extend alignment over (node id, read pos, reverse) seeds
    (reference AlignOneWay seeded, GraphAligner.h:408-491)."""
    t0 = _time.time()
    assert seed_hits
    best_estimated = 0
    best_seed = None
    best_trace = None
    tried: list = []  # (start read pos, end read pos, node index)
    cells = 0  # band cells of every kept slice of every split, as cellsProcessed
    for i, (node_id, pos, reverse) in enumerate(seed_hits):
        node_index = graph.node_lookup[node_id * 2]
        if any(s <= pos <= e and n == node_index for (s, e, n) in tried):
            if logger:
                logger(f"seed {i} already aligned")
            continue
        if logger:
            logger(
                f"seed {i}/{len(seed_hits)} {node_id}{'-' if reverse else '+'},{pos}"
            )
        split = get_split_alignment(
            graph,
            sequence,
            node_id,
            reverse,
            pos,
            initial_bandwidth,
            ramp_bandwidth,
            slice_backend,
        )
        cells += sum(s.cells_processed for t in (split.forward, split.backward)
                     for s in t.slices[1:])
        trace = get_piecewise_traces_from_split(graph, split, sequence)
        _add_alignment_nodes(graph, tried, trace)
        if best_trace is None or split.estimated_correctly_aligned() > best_estimated:
            best_trace = trace
            best_seed = (node_id, pos, reverse)
            best_estimated = split.estimated_correctly_aligned()
    elapsed = int((_time.time() - t0) * 1000)
    if best_trace is None:
        return empty_alignment(elapsed, 0)
    (fw_score, fw_trace), (bw_score, bw_trace) = best_trace
    if fw_score >= INT_MAX and bw_score >= INT_MAX:
        return empty_alignment(elapsed, 0)
    fwresult = trace_to_alignment(graph, seq_id, sequence, fw_score, fw_trace, 0)
    bwresult = trace_to_alignment(graph, seq_id, sequence, bw_score, bw_trace, 0)
    if fwresult.alignment_failed and bwresult.alignment_failed:
        return empty_alignment(elapsed, 0)
    result = merge_alignments(graph, bwresult, fwresult)
    result.cells_processed = cells
    if bw_trace:
        last_aligned = bw_trace[0][1]
    else:
        last_aligned = best_seed[1]
    result.alignment.query_position = last_aligned
    result.alignment_start = last_aligned
    result.alignment_end = result.alignment_start + best_estimated
    result.elapsed_milliseconds = elapsed
    return result


def _add_alignment_nodes(graph: AlignmentGraph, tried: list, trace) -> None:
    """Record per-node read intervals of a trace so later seeds inside an
    already-aligned region are skipped (reference addAlignmentNodes,
    GraphAligner.h:593-633)."""
    for _, t in (trace[0], trace[1]):
        if not t:
            continue
        old_node = graph.index_to_node(t[0][0])
        start_idx = end_idx = t[0][1]
        for w, r in t[1:]:
            node = graph.index_to_node(w)
            if node != old_node:
                tried.append((start_idx, end_idx, old_node))
                start_idx = r
                old_node = node
            end_idx = r
        tried.append((start_idx, end_idx, old_node))
