# Copy of graphaligner_tpu/core/trace_ops.py for the torch port (imports point at graphaligner_tpu_torch).
"""Vectorized host-side trace post-processing for the batched pipeline.

The reference's trace handling (reverseTrace GraphAligner.h:3026-3038,
addAlignmentNodes 593-633, traceToAlignment 782-847) walks the trace one
(graph position, read row) step at a time — ~600 Python-level iterations
per read in the straight port (core.align). The batched pipeline keeps
traces as [n, 2] int64 numpy arrays end-to-end and reduces everything to
node-run boundary arithmetic: per-read cost drops from O(trace steps) to
O(node runs) Python operations (~30).
"""

from __future__ import annotations

import numpy as np

from ..graph.alignment_graph import AlignmentGraph
from ..io import vg
from .result import INT32_MAX, AlignmentResult, empty_alignment

INT_MAX = 2**62


def build_reverse_pos(graph: AlignmentGraph) -> np.ndarray:
    """pos -> reverse-complement strand position lookup ([BP] int64)
    (vectorized AlignmentGraph.get_reverse_position: fw/rc nodes pair by
    digraph node *id* xor 1, resolved through node_lookup)."""
    def safe_rev(n):
        try:
            return graph.get_reverse_node(n)
        except KeyError:
            return n  # dummy start/end have no paired node

    rev_node = np.array(
        [safe_rev(n) for n in range(graph.node_count)], dtype=np.int64
    )
    node = graph.pos_to_node
    other = rev_node[node]
    pos = np.arange(len(node), dtype=np.int64)
    return (graph.node_end[other] - 1) - (pos - graph.node_start[node])


def trim_trace(trace: np.ndarray, limit_row: int) -> np.ndarray:
    """Drop trailing entries with read row >= limit_row (rows are
    non-decreasing in a forward trace)."""
    if len(trace) == 0:
        return trace
    n = int(np.searchsorted(trace[:, 1], limit_row, side="left"))
    return trace[:n]

def reverse_trace(rev_pos: np.ndarray, trace: np.ndarray, end: int) -> np.ndarray:
    """Map a backward trace to forward coordinates (reference
    reverseTrace, GraphAligner.h:3026-3038)."""
    if len(trace) == 0:
        return trace
    out = np.empty_like(trace)
    out[:, 0] = rev_pos[trace[::-1, 0]]
    out[:, 1] = end - trace[::-1, 1]
    return out


def trace_node_runs(graph: AlignmentGraph, trace: np.ndarray):
    """(run start indices, run node ids) of consecutive same-node runs."""
    nodes = graph.pos_to_node[trace[:, 0]]
    starts = np.concatenate([[0], np.nonzero(np.diff(nodes))[0] + 1])
    return starts, nodes[starts]


def add_alignment_nodes(graph: AlignmentGraph, tried: list, traces) -> None:
    """Record per-node read intervals of fw/bw traces (reference
    addAlignmentNodes, GraphAligner.h:593-633)."""
    for _, t in traces:
        if len(t) == 0:
            continue
        starts, nodes = trace_node_runs(graph, t)
        ends = np.concatenate([starts[1:], [len(t)]]) - 1
        tried.extend(
            zip(
                t[starts, 1].tolist(),
                t[ends, 1].tolist(),
                nodes.tolist(),
            )
        )


def trace_to_alignment(
    graph: AlignmentGraph,
    seq_id: str,
    sequence: str,
    score: int,
    trace: np.ndarray,
    cells_processed: int,
) -> AlignmentResult:
    """Array-based traceToAlignment (GraphAligner.h:782-847), including
    the reference's missing +1 on the final edit's from_length."""
    aln = vg.Alignment(name=seq_id, score=score, sequence=sequence, path=vg.Path())
    if len(trace) == 0:
        return AlignmentResult(aln, True, cells_processed, INT_MAX)
    starts, nodes = trace_node_runs(graph, trace)
    ends = np.concatenate([starts[1:], [len(trace)]]) - 1
    # skip leading dummy-start runs (the walk can begin on the dummy)
    k = 0
    while k < len(nodes) and nodes[k] == graph.dummy_node_start:
        k += 1
    if k == len(nodes):
        return empty_alignment(INT_MAX, cells_processed)
    if nodes[k] == graph.dummy_node_end:
        return empty_alignment(INT_MAX, cells_processed)
    # truncate at the dummy end node
    stop = len(nodes)
    hits = np.nonzero(nodes[k:] == graph.dummy_node_end)[0]
    if len(hits):
        stop = k + int(hits[0])
    # per-run scalars, converted from numpy in bulk (per-element item
    # reads are ~30x slower than one .tolist())
    nr = stop - k
    s_idx, e_idx = starts[k:stop], ends[k:stop]
    node_run = nodes[k:stop]
    w_start = trace[s_idx, 0]
    w_end = trace[e_idx, 0]
    r_start = trace[s_idx, 1].tolist()
    r_end_a = trace[e_idx, 1]
    from_len = w_end - w_start + 1
    from_len[-1] -= 1
    to_len = np.empty(nr, dtype=np.int64)
    to_len[0] = r_end_a[0] - trace[s_idx[0], 1]
    to_len[1:] = r_end_a[1:] - r_end_a[:-1]
    from_len = from_len.tolist()
    to_len = to_len.tolist()
    node_id_l = graph.node_ids[node_run].tolist()
    rev_l = graph.reverse[node_run].tolist()
    first_off = int(trace[s_idx[0], 0] - graph.node_start[node_run[0]])
    mappings = aln.path.mapping
    Mapping, Position, Edit = vg.Mapping, vg.Position, vg.Edit
    for idx in range(nr):
        if idx == 0:
            m = Mapping(
                position=Position(
                    node_id=node_id_l[0],
                    is_reverse=bool(rev_l[0]),
                    offset=first_off,
                ),
                rank=0,
            )
        else:
            m = Mapping(
                position=Position(
                    node_id=node_id_l[idx], is_reverse=bool(rev_l[idx])
                ),
                rank=idx,
            )
        tl = to_len[idx]
        rs = r_start[idx]
        m.edit = [
            Edit(
                from_length=from_len[idx],
                to_length=tl,
                sequence=sequence[rs : rs + tl],
            )
        ]
        mappings.append(m)
    return AlignmentResult(aln, False, cells_processed, INT_MAX)


def trace_to_runs(graph: AlignmentGraph, trace: np.ndarray):
    """Per-mapping run arrays of a forward trace (the array core of
    trace_to_alignment, without building vg objects): dict with
    node_idx/node_id/rev/offsets/ranks/from_len/to_len/rstart arrays,
    or None when the trace is empty / all-dummy (alignment failed)."""
    if len(trace) == 0:
        return None
    starts, nodes = trace_node_runs(graph, trace)
    ends = np.concatenate([starts[1:], [len(trace)]]) - 1
    k = 0
    while k < len(nodes) and nodes[k] == graph.dummy_node_start:
        k += 1
    if k == len(nodes) or nodes[k] == graph.dummy_node_end:
        return None
    stop = len(nodes)
    hits = np.nonzero(nodes[k:] == graph.dummy_node_end)[0]
    if len(hits):
        stop = k + int(hits[0])
    s_idx, e_idx = starts[k:stop], ends[k:stop]
    node_run = nodes[k:stop]
    nr = stop - k
    w_start = trace[s_idx, 0]
    w_end = trace[e_idx, 0]
    r_end = trace[e_idx, 1]
    from_len = w_end - w_start + 1
    from_len[-1] -= 1
    to_len = np.empty(nr, dtype=np.int64)
    to_len[0] = r_end[0] - trace[s_idx[0], 1]
    to_len[1:] = r_end[1:] - r_end[:-1]
    offsets = np.zeros(nr, dtype=np.int64)
    offsets[0] = trace[s_idx[0], 0] - graph.node_start[node_run[0]]
    return {
        "node_idx": node_run,
        "node_id": graph.node_ids[node_run],
        "rev": graph.reverse[node_run],
        "offsets": offsets,
        "ranks": np.arange(nr, dtype=np.int64),
        "from_len": from_len,
        "to_len": to_len,
        "rstart": trace[s_idx, 1],
    }


def merge_runs(graph: AlignmentGraph, bw, fw):
    """Concatenate backward+forward run arrays (mergeAlignments,
    GraphAligner.h:648-688, on arrays). bw/fw: dict | None."""
    if bw is None:
        return fw
    if fw is None:
        return bw
    start = 0
    if (
        bw["node_id"][-1] == fw["node_id"][0]
        and bw["rev"][-1] == fw["rev"][0]
    ):
        start = 1
    merged = {
        key: np.concatenate([bw[key], fw[key][start:]])
        for key in bw
    }
    return merged
