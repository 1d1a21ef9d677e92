# Copy of graphaligner_tpu/io/gfa.py for the torch port (imports point at graphaligner_tpu_torch).
"""Standalone in-memory GFA graph model, used by the tooling layer
(reference: GfaGraph.h:33-45, GfaGraph.cpp).

Semantics match the reference: only S and L lines are read; the edge
overlap must be uniform across all L lines; an edge key is (node id,
end-of-node?) where '+' orientation means the *end* of the from-node and
the *start* of the to-node.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

# A node position: (id, end). end=True means the forward-orientation side.
NodePos = Tuple[int, bool]


def reverse_pos(pos: NodePos) -> NodePos:
    return (pos[0], not pos[1])


@dataclass
class GfaGraph:
    nodes: Dict[int, str] = field(default_factory=dict)
    edges: Dict[NodePos, List[NodePos]] = field(default_factory=dict)
    edge_overlap: int = -1

    @classmethod
    def load(cls, path: str) -> "GfaGraph":
        g = cls()
        with open(path, "r") as f:
            for raw in f:
                line = raw.rstrip("\r\n")
                if not line:
                    continue
                if line[0] == "S":
                    parts = line.split("\t")
                    g.nodes[int(parts[1])] = parts[2]
                elif line[0] == "L":
                    parts = line.split("\t")
                    frm, fromdir, to, todir = (
                        int(parts[1]),
                        parts[2],
                        int(parts[3]),
                        parts[4],
                    )
                    overlap = int(parts[5].rstrip("M")) if len(parts) > 5 else 0
                    if g.edge_overlap not in (-1, overlap):
                        raise ValueError(
                            f"non-uniform GFA edge overlap: {overlap} vs {g.edge_overlap}"
                        )
                    g.edge_overlap = overlap
                    frompos = (frm, fromdir == "+")
                    topos = (to, todir == "+")
                    g.edges.setdefault(frompos, []).append(topos)
        return g

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for node_id, seq in self.nodes.items():
                f.write(f"S\t{node_id}\t{seq}\n")
            for frompos, targets in self.edges.items():
                for topos in targets:
                    f.write(
                        f"L\t{frompos[0]}\t{'+' if frompos[1] else '-'}"
                        f"\t{topos[0]}\t{'+' if topos[1] else '-'}"
                        f"\t{self.edge_overlap}M\n"
                    )

    def subgraph(self, ids: Set[int]) -> "GfaGraph":
        result = GfaGraph(edge_overlap=self.edge_overlap)
        for node in ids:
            if node not in self.nodes:
                continue
            result.nodes[node] = self.nodes[node]
            for end in (True, False):
                key = (node, end)
                for target in self.edges.get(key, []):
                    if target[0] not in ids:
                        continue
                    result.edges.setdefault(key, []).append(target)
        return result

    def add_subgraph(self, other: "GfaGraph") -> None:
        for node_id, seq in other.nodes.items():
            existing = self.nodes.get(node_id)
            if existing is not None and existing != seq:
                raise ValueError(f"conflicting sequences for node {node_id}")
            self.nodes[node_id] = seq
        for frompos, targets in other.edges.items():
            self.edges.setdefault(frompos, []).extend(targets)
        if self.edge_overlap == -1:
            self.edge_overlap = other.edge_overlap
