# Frozen copy of graphaligner_tpu_torch/core/backtrace.py, part of the benchmark's plain reference (imports nothing of the program).
"""Backtrace: predecessor walk over computed slices and trace assembly.

Replicates the reference's pickBacktracePredecessor (GraphAligner.h:493-591)
— including its check order (special row-0 stop, then per in-neighbor
horizontal then diagonal, then vertical) which defines tie-breaking — and
the slice/boundary walk structure of getTraceFromTable/getTraceFromSlice/
getSliceBoundaryTrace (GraphAligner.h:894-1021). Because this framework
stores every slice (memory is cheap host-side; the TPU engine
rematerializes on device instead), the sqrt-sampled recompute pass
(getSlicesFromTable, 2858-2943) is unnecessary: walking the stored slices
yields the identical trace.
"""

from __future__ import annotations

from .graph import AlignmentGraph
from .oracle import SliceScores
from .params import WORD_SIZE

INT_MAX = 2**62


def ref_character_match(seq_char: str, graph_char: str) -> bool:
    """characterMatch as the NDEBUG reference behaves during backtrace:
    'N' matches anything (including dummy '-'); other IUPAC codes match
    their base sets; dummy graph chars match nothing else
    (GraphAligner.h:2039-2110)."""
    c = seq_char.upper()
    if c == "N":
        return True
    sets = {
        "A": "A", "T": "T", "C": "C", "G": "G",
        "R": "AG", "Y": "CT", "K": "GT", "M": "CA",
        "S": "CG", "W": "AT", "B": "CGT", "D": "AGT",
        "H": "ACT", "V": "ACG",
    }
    if c not in sets:
        raise ValueError(f"unsupported read character {seq_char!r}")
    return graph_char in sets[c]


def pick_backtrace_predecessor(
    graph: AlignmentGraph,
    sequence: str,
    slc: SliceScores,
    pos: tuple,
    previous: SliceScores,
) -> tuple:
    w, row = pos
    assert slc.j <= row < slc.j + WORD_SIZE
    node = graph.index_to_node(w)
    score_here = slc.get_value(graph, row - slc.j, w)
    if row == 0 and previous.has_node(node) and score_here in (0, 1):
        return (w, row - 1)
    default = len(sequence)

    def diagonal_score(u):
        if row == slc.j:
            return previous.get_value_or_max(graph, WORD_SIZE - 1, u, default)
        return slc.get_value_or_max(graph, row - 1 - slc.j, u, default)

    if w == graph.node_start[node]:
        preds = [int(graph.node_end[nb]) - 1 for nb in graph.in_neighbors(node)]
    else:
        preds = [w - 1]
    graph_char = graph.node_sequence_char(w)
    matched = ref_character_match(sequence[row], graph_char)
    for u in preds:
        horizontal = slc.get_value_or_max(graph, row - slc.j, u, default)
        if horizontal == score_here - 1:
            return (u, row)
        diagonal = diagonal_score(u)
        if matched:
            if diagonal == score_here:
                return (u, row - 1)
        else:
            if diagonal == score_here - 1:
                return (u, row - 1)
    if row == slc.j:
        score_up = previous.get_value_or_max(graph, WORD_SIZE - 1, w, default)
    else:
        score_up = slc.get_value_or_max(graph, row - 1 - slc.j, w, default)
    if score_up == score_here - 1:
        return (w, row - 1)
    raise AssertionError(f"no backtrace predecessor at {pos} (score {score_here})")


def get_trace_from_table(
    graph: AlignmentGraph, sequence: str, table
) -> tuple:
    """Walk the full stored table; returns (score, trace) with trace as
    (graph position, read row) pairs in forward order."""
    if not table.slices or not table.bandwidth_per_slice:
        return (INT_MAX, [])
    last = table.slices[-1]
    assert last.min_score_index, "final slice has no minimum index"
    score = last.min_score
    trace = [(last.min_score_index[-1], last.j + WORD_SIZE - 1)]
    for i in range(len(table.slices) - 1, 0, -1):
        slc = table.slices[i]
        prev = table.slices[i - 1]
        pos = trace[-1]
        # within-slice walk down to the slice's first row
        while pos[1] != slc.j:
            pos = pick_backtrace_predecessor(graph, sequence, slc, pos, slc)
            trace.append(pos)
        # boundary walk into the previous slice
        while pos[1] == slc.j:
            pos = pick_backtrace_predecessor(graph, sequence, slc, pos, prev)
            trace.append(pos)
    assert trace[-1][1] == -1
    trace.pop()
    assert trace[-1][1] == 0
    trace.reverse()
    return (score, trace)
