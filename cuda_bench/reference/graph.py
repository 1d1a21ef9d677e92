# Frozen copy of graphaligner_tpu_torch/graph/alignment_graph.py, part of the benchmark's plain reference (imports nothing of the program).
"""The runtime graph index: flat arrays ready for device residency.

TPU-first redesign of the reference's AlignmentGraph (AlignmentGraph.h:13-60,
AlignmentGraph.cpp). Differences by design:

- Sequences are stored as a uint8 code array (A=0,T=1,C=2,G=3, dummy=4)
  instead of two parallel bitvectors (reference AlignmentGraph.cpp:61-85);
  the 2-bit split there exists to build Eq bitvectors cheaply, which we do
  from per-slice read masks instead (see ops/myers.py).
- IndexToNode is a precomputed pos→node int32 array instead of a binary
  search per lookup (reference AlignmentGraph.cpp:226-234 — hot in
  backtrace).
- Adjacency is CSR (in/out), edge order preserving reference insertion
  order so that merge folds visit neighbors identically.
- SCC condensation + topological order are computed once here at
  finalize, not per-slice (reference Tarjans the banded subgraph every
  slice, GraphAligner.h:2352-2359).

The dummy start node occupies index 0 / position 0, and a dummy end node
is appended at finalize (reference AlignmentGraph.cpp:22-31, 108-127);
both have digraph node id 0, sequence '-', and no edges.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import scc as scc_mod

# Sequence codes; order matches the reference's 2-bit decode "ATCG"
# (AlignmentGraph.cpp:252-260) so code = first_bit*2 + second_bit.
CODE_A, CODE_T, CODE_C, CODE_G, CODE_DUMMY = 0, 1, 2, 3, 4
_CHAR_TO_CODE = {"A": CODE_A, "T": CODE_T, "C": CODE_C, "G": CODE_G, "-": CODE_DUMMY}
_CODE_TO_CHAR = "ATCG-"


@dataclass
class GraphStats:
    nodes: int
    bp: int
    edges: int
    high_in_degree_nodes: int


class AlignmentGraph:
    """Build with add_node/add_edge, then finalize().

    After finalize() all index arrays are immutable numpy arrays; the
    engine uploads the ones it needs to device memory once per graph.
    """

    def __init__(self):
        self._node_ids: list[int] = [0]  # dummy start, id 0
        self._node_seqs: list[str] = ["-"]
        self._reverse: list[bool] = [False]
        self._node_lookup: dict[int, int] = {}
        self._in_neighbors: list[list[int]] = [[]]
        self._out_neighbors: list[list[int]] = [[]]
        self.dbg_overlap: int = 0
        self.finalized = False

    # -- construction ------------------------------------------------------

    def add_node(self, node_id: int, sequence: str, reverse_node: bool) -> None:
        assert not self.finalized
        if node_id in self._node_lookup:
            # subgraph extraction may produce duplicates; keep the first
            # (reference AlignmentGraph.cpp:50-52)
            return
        if not sequence or set(sequence) - {"A", "C", "G", "T"}:
            raise ValueError(
                f"node {node_id}: graph sequences must be non-empty ACGT, got {sequence!r}"
            )
        self._node_lookup[node_id] = len(self._node_ids)
        self._node_ids.append(node_id)
        self._node_seqs.append(sequence)
        self._reverse.append(reverse_node)
        self._in_neighbors.append([])
        self._out_neighbors.append([])

    def add_edge(self, node_id_from: int, node_id_to: int) -> None:
        assert not self.finalized
        frm = self._node_lookup[node_id_from]
        to = self._node_lookup[node_id_to]
        if frm not in self._in_neighbors[to]:
            self._in_neighbors[to].append(frm)
        if to not in self._out_neighbors[frm]:
            self._out_neighbors[frm].append(to)

    def finalize(self) -> GraphStats:
        assert not self.finalized
        # dummy end node (reference AlignmentGraph.cpp:108-118)
        self._node_ids.append(0)
        self._node_seqs.append("-")
        self._reverse.append(False)
        self._in_neighbors.append([])
        self._out_neighbors.append([])

        n = len(self._node_ids)
        lens = np.array([len(s) for s in self._node_seqs], dtype=np.int64)
        # one pass over the concatenated bytes via a 256-entry LUT
        # (a per-node Python loop took minutes at pangenome scale)
        joined = np.frombuffer(
            "".join(self._node_seqs).encode("ascii"), dtype=np.uint8
        )
        lut = np.zeros(256, dtype=np.uint8)
        for ch, code in _CHAR_TO_CODE.items():
            lut[ord(ch)] = code

        def to_csr(neigh):
            counts = np.array([len(x) for x in neigh], dtype=np.int64)
            ptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=ptr[1:])
            idx = np.array(
                [v for lst in neigh for v in lst], dtype=np.int32
            ) if ptr[-1] else np.zeros(0, dtype=np.int32)
            return ptr, idx

        stats = self._index(
            np.array(self._node_ids, dtype=np.int64),
            np.array(self._reverse, dtype=bool),
            lens,
            lut[joined],
            *to_csr(self._in_neighbors),
            *to_csr(self._out_neighbors),
            dict(self._node_lookup),
        )
        # drop the construction-time sequences
        del self._node_seqs
        return stats

    @classmethod
    def from_arrays(cls, node_ids, reverse, node_len, seq_codes, edge_from,
                    edge_to) -> "AlignmentGraph":
        """A finalized graph from flat arrays: what add_node, add_edge and
        finalize build from the nodes and the edges in the order given.
        Node indices count from 1 (0 is the dummy start node; both dummy
        nodes are added here); ``seq_codes`` holds the nodes' codes back to
        back; edges (``edge_from[i]`` -> ``edge_to[i]``, node indices) must
        not repeat."""
        g = cls()
        n = len(node_ids) + 2
        lens = np.concatenate([[1], node_len, [1]]).astype(np.int64)
        dummy = np.full(1, CODE_DUMMY, dtype=np.uint8)
        codes = np.concatenate([dummy, seq_codes, dummy]).astype(np.uint8)
        ids = np.concatenate([[0], node_ids, [0]]).astype(np.int64)
        rev = np.concatenate([[False], reverse, [False]]).astype(bool)
        edge_from = np.asarray(edge_from, dtype=np.int64)
        edge_to = np.asarray(edge_to, dtype=np.int32)

        def to_csr(key, val):
            order = np.argsort(key, kind="stable")  # insertion order kept
            ptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(np.bincount(key, minlength=n), out=ptr[1:])
            return ptr, val[order].astype(np.int32)

        g._node_lookup = dict(zip(ids[1:-1].tolist(), range(1, n - 1)))
        g._index(ids, rev, lens, codes, *to_csr(edge_to, edge_from),
                 *to_csr(edge_from, edge_to), g._node_lookup)
        del g._node_seqs
        return g

    def _index(self, node_ids, reverse, lens, seq_codes, in_ptr, in_idx,
               out_ptr, out_idx, node_lookup) -> GraphStats:
        """The finalized arrays, the condensation and the stats."""
        n = len(node_ids)
        self.node_start = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=self.node_start[1:])
        self.node_len = lens
        self.node_end = self.node_start + lens
        total_bp = int(self.node_end[-1])
        self.node_ids = node_ids
        self.reverse = reverse
        self.seq_codes = seq_codes
        self.pos_to_node = np.repeat(
            np.arange(n, dtype=np.int32), lens
        )
        self.in_ptr, self.in_idx = in_ptr, in_idx
        self.out_ptr, self.out_idx = out_ptr, out_idx
        self.node_lookup = node_lookup
        self.dummy_node_start = 0
        self.dummy_node_end = n - 1

        (
            self.comp_id,
            self.num_comps,
            self.comp_cyclic,
            self.topo_node_order,
        ) = scc_mod.condensation(self.out_ptr, self.out_idx)

        self.finalized = True
        in_deg = np.diff(self.in_ptr)
        self.stats = GraphStats(
            nodes=n,
            bp=total_bp,
            edges=int(self.in_ptr[-1]),
            high_in_degree_nodes=int((in_deg >= 2).sum()),
        )
        return self.stats

    # -- queries (reference AlignmentGraph.cpp:199-364) ---------------------

    @property
    def node_count(self) -> int:
        return len(self.node_ids)

    @property
    def size_in_bp(self) -> int:
        return len(self.seq_codes)

    def index_to_node(self, pos: int) -> int:
        return int(self.pos_to_node[pos])

    def node_sequence_char(self, pos: int) -> str:
        return _CODE_TO_CHAR[self.seq_codes[pos]]

    def get_reverse_node(self, node_index: int) -> int:
        node_id = int(self.node_ids[node_index])
        bigraph_id = node_id // 2
        if node_id % 2 == 1:
            return self.node_lookup[bigraph_id * 2]
        return self.node_lookup[bigraph_id * 2 + 1]

    def get_reverse_position(self, pos: int) -> int:
        node = self.index_to_node(pos)
        other = self.get_reverse_node(node)
        return int((self.node_end[other] - 1) - (pos - self.node_start[node]))

    def out_neighbors(self, node_index: int) -> np.ndarray:
        return self.out_idx[self.out_ptr[node_index] : self.out_ptr[node_index + 1]]

    def in_neighbors(self, node_index: int) -> np.ndarray:
        return self.in_idx[self.in_ptr[node_index] : self.in_ptr[node_index + 1]]

    def project_forward(self, start_positions: set[int], amount: int) -> set[int]:
        """Positions exactly ``amount`` bp forward of any start position
        (reference AlignmentGraph.cpp:161-197)."""
        layers: list[set[int]] = [set() for _ in range(amount + 1)]
        layers[0] |= start_positions
        for i in range(amount):
            left = amount - i
            for pos in layers[i]:
                node = self.index_to_node(pos)
                end = int(self.node_end[node])
                if pos + left < end:
                    layers[-1].add(pos + left)
                elif pos + left == end:
                    for nb in self.out_neighbors(node):
                        layers[-1].add(int(self.node_start[nb]))
                else:
                    for nb in self.out_neighbors(node):
                        layers[i + end - pos].add(int(self.node_start[nb]))
        return layers[-1]

    def min_distance(self, pos: int, targets: list[int]) -> int:
        """Min gap distance from pos to any target position, Dijkstra over
        node endpoints (reference AlignmentGraph.cpp:285-364)."""
        import heapq

        assert targets
        valid_nodes = {self.index_to_node(t) for t in targets}
        mindist = np.iinfo(np.int64).max
        node = self.index_to_node(pos)
        if node in valid_nodes:
            for t in targets:
                if self.index_to_node(t) == node:
                    mindist = min(mindist, abs(t - pos))
        # heap of (distance, node, at_start?)
        heap = [
            (int(pos - self.node_start[node]), node, True),
            (int(self.node_end[node] - 1 - pos), node, False),
        ]
        dist_at_start: dict[int, int] = {}
        dist_at_end: dict[int, int] = {}
        while heap:
            d, v, at_start = heapq.heappop(heap)
            if d >= mindist:
                break
            book = dist_at_start if at_start else dist_at_end
            if v in book and book[v] <= d:
                continue
            book[v] = d
            if v in valid_nodes:
                for t in targets:
                    if self.index_to_node(t) == v:
                        if at_start:
                            mindist = min(mindist, d + t - int(self.node_start[v]))
                        else:
                            mindist = min(mindist, d + int(self.node_end[v]) - 1 - t)
            if at_start:
                heapq.heappush(heap, (d + int(self.node_len[v]) - 1, v, False))
                for nb in self.in_neighbors(v):
                    heapq.heappush(heap, (d + 1, int(nb), False))
            else:
                heapq.heappush(heap, (d + int(self.node_len[v]) - 1, v, True))
                for nb in self.out_neighbors(v):
                    heapq.heappush(heap, (d + 1, int(nb), True))
        return int(mindist)
