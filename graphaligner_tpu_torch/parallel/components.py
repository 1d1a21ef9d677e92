# Copy of graphaligner_tpu/parallel/components.py for the torch port (the native GFA parser only, no pure-Python fallback).
"""Component-sharded pangenome distribution (SURVEY §5 distributed
bullet; BASELINE config 5).

For whole-pangenome graphs the per-host replicated index stops fitting;
the graph is instead partitioned by BIGRAPH connected component (both
orientations of a node share a component by construction, so a read's
forward and reverse-complement extensions stay on one host), components
are balanced across hosts by bp, and reads route to the host owning
their seeds' component. Every host computes the identical plan from the
graph topology + seed map — no coordination traffic, mirroring the
reference's deterministic shared-stack split lifted to hosts
(Aligner.cpp:276-306).

Bit-identity with the single-process run is preserved exactly: two
components whose members are named by the SAME read's seed set are
co-assigned (union-find over reads), so every read is aligned by one
host holding all graph context its seeds can reach, and the global
ordinal sidecar (parallel.distributed) reconstructs the single-process
output order byte for byte.
"""

from __future__ import annotations

from ..io import stream, vg


class UnionFind:
    __slots__ = ("parent", "size")

    def __init__(self):
        self.parent: dict = {}
        self.size: dict = {}

    def add(self, x) -> None:
        if x not in self.parent:
            self.parent[x] = x
            self.size[x] = 1

    def find(self, x):
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a, b) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]


def graph_topology(path: str):
    """Sequence-light parse of a .vg/.gfa graph: returns
    (node_bp: {bigraph id -> bp}, edges: [(from id, to id)])."""
    node_bp: dict = {}
    edges: list = []
    if path.endswith(".vg"):
        for chunk in stream.read_messages(path, vg.Graph):
            for node in chunk.node:
                node_bp[node.id] = len(node.sequence)
            for edge in chunk.edge:
                edges.append((edge.from_, edge.to))
    elif path.endswith(".gfa"):
        from ..io import native

        with open(path, "rb") as f:
            data = f.read()
        s_records, l_records = native.parse_gfa(data)
        for node_id, seq in s_records:
            node_bp[node_id] = len(seq)
        for from_id, _fm, to_id, _tm, _ov in l_records:
            edges.append((from_id, to_id))
    else:
        raise ValueError(f"unknown graph format: {path}")
    return node_bp, edges


def shard_plan(node_bp: dict, edges: list, seed_map: dict, process_count: int):
    """Deterministic component→host assignment.

    1. Union-find over bigraph edges = connected components.
    2. Components named by one read's seed set are unioned (the read
       must see all of them on one host).
    3. Greedy balance: groups sorted by (-bp, min id) go to the
       currently lightest host (ties → lowest host index).

    Returns (uf, host_of_root: {component root -> host index}).
    """
    uf = UnionFind()
    for nid in node_bp:
        uf.add(nid)
    for a, b in edges:
        if a in uf.parent and b in uf.parent:
            uf.union(a, b)
    for seeds in seed_map.values():
        prev = None
        for node_id, _pos, _rev in seeds:
            if node_id not in uf.parent:
                continue
            if prev is not None:
                uf.union(prev, node_id)
            prev = node_id
    group_bp: dict = {}
    group_min: dict = {}
    for nid, bp in node_bp.items():
        r = uf.find(nid)
        group_bp[r] = group_bp.get(r, 0) + bp
        if r not in group_min or nid < group_min[r]:
            group_min[r] = nid
    order = sorted(group_bp, key=lambda r: (-group_bp[r], group_min[r]))
    load = [0] * max(1, process_count)
    host_of_root: dict = {}
    for r in order:
        h = min(range(len(load)), key=lambda i: (load[i], i))
        host_of_root[r] = h
        load[h] += group_bp[r]
    return uf, host_of_root


def load_component_shard(
    path: str, seed_map: dict, process_index: int, process_count: int
):
    """Build THIS host's subgraph (original bigraph ids preserved) and
    the read router. Returns (graph, read_host) where
    read_host(seq_id) -> owning host index (reads with no usable seeds
    go to host 0; they emit no output message on any host, so placement
    does not affect the merged bytes)."""
    from ..graph.bigraph import load_alignment_graph

    node_bp, edges = graph_topology(path)
    uf, host_of_root = shard_plan(node_bp, edges, seed_map, process_count)
    keep = {
        nid
        for nid in node_bp
        if host_of_root[uf.find(nid)] == process_index
    }
    graph = load_alignment_graph(path, keep=keep)

    def read_host(seq_id: str) -> int:
        for node_id, _pos, _rev in seed_map.get(seq_id, []):
            if node_id in uf.parent:
                return host_of_root[uf.find(node_id)]
        return 0

    return graph, read_host
