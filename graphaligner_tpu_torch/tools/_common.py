# Copy of graphaligner_tpu/tools/_common.py for the torch port (imports point at graphaligner_tpu_torch).
"""Shared helpers for the CLI tools."""

from __future__ import annotations

from ..io import stream, vg


def load_vg_graph(path: str) -> vg.Graph:
    """Merge all Graph chunks in a vg file (reference
    CommonUtils::LoadVGGraph, CommonUtils.cpp:27-36)."""
    merged = vg.Graph()
    for g in stream.read_messages(path, vg.Graph):
        merged.node.extend(g.node)
        merged.edge.extend(g.edge)
        merged.path.extend(g.path)
    return merged


def load_alignments(path: str) -> list:
    return stream.read_messages(path, vg.Alignment)


def write_alignments(path: str, alignments: list) -> None:
    stream.write_messages(path, alignments)


def node_sizes(graph: vg.Graph) -> dict:
    return {n.id: len(n.sequence) for n in graph.node}
