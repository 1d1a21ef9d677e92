# Copy of graphaligner_tpu/graph/bigraph.py for the torch port (the native GFA parser only, no pure-Python fallback).
"""Bidirected vg/GFA graph → doubled digraph (reference: BigraphToDigraph.cpp).

Every bidirected node id becomes two digraph nodes: forward = id*2, reverse
complement = id*2+1 (BigraphToDigraph.cpp:27-30). Every bidirected edge
becomes two directed edges (fromRight→toRight and toLeft→fromLeft,
BigraphToDigraph.cpp:32-56). GFA 'S' sequences are truncated by the uniform
edge overlap, which is remembered as dbg_overlap and compensated during
split alignment (BigraphToDigraph.cpp:58-68, 141-158).
"""

from __future__ import annotations

from ..io import stream, vg
from ..io.sequences import reverse_complement
from .alignment_graph import AlignmentGraph


def _convert_edge(from_id: int, from_start: bool, to_id: int, to_end: bool):
    """One bidirected edge → two directed edges over doubled node ids
    (reference BigraphToDigraph.cpp:32-56)."""
    if from_start:
        from_left, from_right = from_id * 2, from_id * 2 + 1
    else:
        from_left, from_right = from_id * 2 + 1, from_id * 2
    if to_end:
        to_left, to_right = to_id * 2, to_id * 2 + 1
    else:
        to_left, to_right = to_id * 2 + 1, to_id * 2
    return (from_right, to_right), (to_left, from_left)


def graph_from_vg(graphs: list[vg.Graph], keep=None) -> AlignmentGraph:
    """Build from vg Graph chunks: all nodes first, then all edges
    (two passes, reference BigraphToDigraph.cpp:106-135). keep, when
    given, is a set of bigraph node ids to retain — the component-shard
    subgraph filter (parallel.components): dropped nodes and any edge
    touching one are skipped, ids are preserved."""
    g = AlignmentGraph()
    for chunk in graphs:
        for node in chunk.node:
            if keep is not None and node.id not in keep:
                continue
            g.add_node(node.id * 2, node.sequence, reverse_node=False)
            g.add_node(
                node.id * 2 + 1, reverse_complement(node.sequence), reverse_node=True
            )
    for chunk in graphs:
        for edge in chunk.edge:
            if keep is not None and (
                edge.from_ not in keep or edge.to not in keep
            ):
                continue
            e1, e2 = _convert_edge(edge.from_, edge.from_start, edge.to, edge.to_end)
            g.add_edge(*e1)
            g.add_edge(*e2)
    g.finalize()
    return g


def graph_from_vg_file(path: str, keep=None) -> AlignmentGraph:
    return graph_from_vg(stream.read_messages(path, vg.Graph), keep=keep)


def graph_from_gfa_file(path: str, keep=None) -> AlignmentGraph:
    """Build from a GFA file; node sequences are trimmed by the uniform
    edge overlap (reference BigraphToDigraph.cpp:137-189). Note GFA '+'
    orientation maps to from_start=False / to_end=False."""
    from ..io import native

    with open(path, "rb") as f:
        data = f.read()
    s_lines, l_records = native.parse_gfa(data)
    l_lines: list[tuple[int, bool, int, bool]] = []
    overlap = 0
    for from_id, from_minus, to_id, to_minus, this_overlap in l_records:
        if overlap not in (0, this_overlap):
            raise ValueError(
                f"non-uniform GFA overlap {this_overlap} vs {overlap}"
            )
        overlap = this_overlap
        l_lines.append((from_id, from_minus, to_id, to_minus))
    g = AlignmentGraph()
    g.dbg_overlap = overlap
    for node_id, seq in s_lines:
        if keep is not None and node_id not in keep:
            continue
        if len(seq) <= overlap:
            raise ValueError(
                f"GFA node {node_id}: sequence length {len(seq)} <= overlap {overlap}"
            )
        trimmed = seq[: len(seq) - overlap]
        rc_trimmed = reverse_complement(seq)[: len(seq) - overlap]
        g.add_node(node_id * 2, trimmed, reverse_node=False)
        g.add_node(node_id * 2 + 1, rc_trimmed, reverse_node=True)
    for from_id, from_start, to_id, to_end in l_lines:
        if keep is not None and (from_id not in keep or to_id not in keep):
            continue
        e1, e2 = _convert_edge(from_id, from_start, to_id, to_end)
        g.add_edge(*e1)
        g.add_edge(*e2)
    g.finalize()
    return g


def load_alignment_graph(path: str, keep=None) -> AlignmentGraph:
    """Load by extension: .vg → vg protobuf, .gfa → GFA
    (reference Aligner.cpp:207-229). keep = optional bigraph node-id
    filter (component-shard subgraph, parallel.components)."""
    if path.endswith(".vg"):
        return graph_from_vg_file(path, keep=keep)
    if path.endswith(".gfa"):
        return graph_from_gfa_file(path, keep=keep)
    raise ValueError(f"unknown graph format: {path} (expected .vg or .gfa)")
