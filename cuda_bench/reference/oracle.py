# Frozen copy of graphaligner_tpu_torch/core/oracle.py, part of the benchmark's plain reference (imports nothing of the program).
"""Exact scalar slice DP — the behavioral specification of the engine.

This module computes one 64-row DP slice over a banded subgraph with
score semantics identical to the reference's bit-parallel engine
(GraphAligner.h: getNextSlice 1349-1427, calculateNode 1457-1573,
forceComponentZeroRow 1903-1995, calculateSlice 2331-2451, and the
cell-by-cell specification getWordSliceCellByCell 1163-1266). It is the
test oracle for the vectorized TPU engine and the reference for the
banded alignment pipeline.

DP orientation: rows = read positions (64 per slice), columns = graph
positions. Scores are unit-cost edit distance; the read must be fully
consumed, the graph is local (alignment may start/end anywhere in the
initial band / graph).

Key semantics distilled from the reference:

- Row j-1 ("scoreBeforeStart", here ``sbs``) is computed by a min-closure
  over the band: seeds are the previous slice's last-row scores for cells
  in the previous band, previous-band in-neighbor last-cell scores + 1 at
  node starts, and (for band-source nodes absent from the previous band)
  len(seq)+1; relaxation is +1 per horizontal step
  (≡ forceComponentZeroRow's per-component Dijkstra).
- A cell's row j-1 value "exists" (may donate a *match* diagonal into
  row j) iff the cell was in the previous band, its sbs equals the
  previous slice's value, and that value existed
  (≡ the scoreBeforeExists stamping in forceComponentZeroRow:1986).
- Row j (first row): vertical sbs+1; diagonal from predecessor u costs
  0 only when the read char matches and sbs[u] exists, else 1; nodes
  whose in-neighbors are only in the previous band contribute a pseudo
  column from their old last-row score (≡ getNodeStartSlice's
  hasRealNeighbor=false path with EqHere&=1); band-source nodes in the
  previous band additionally get a free-start diagonal at slice 0
  (≡ getSourceSliceFromStartMatch).
- Rows j+1..j+63: the standard graph-Levenshtein recurrence with
  horizontal min-closure per row (cycles converge because closure = the
  reference's confirmedRows fixpoint).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from .graph import AlignmentGraph, _CODE_TO_CHAR
from .sequences import IUPAC_MATCHES
from .hmm import CorrectnessState
from .params import WORD_SIZE

BIG = np.int64(1 << 40)

# Band size (cells) at which compute_slice switches to the native C++
# slice engine. The reference takes it for every band: its values are those
# of the Python slice below, which is about 20x slower on 10 kb reads.
NATIVE_MIN_CELLS = 0


@dataclass
class SliceScores:
    """Computed scores of one DP slice over its band."""

    j: int
    nodes: list  # band nodes in processing order
    # per node: dict node -> arrays over node cells
    sbs: dict  # row j-1 scores, int64[L]
    sbs_exists: dict  # bool[L]
    rows: dict  # int64[64, L] rows j..j+63
    end_exists: dict  # bool[L] (always True in the bitvector method)
    min_score: int = 0
    min_score_index: list = field(default_factory=list)  # graph positions
    node_min: dict = field(default_factory=dict)
    correctness: CorrectnessState = field(default_factory=CorrectnessState)
    bandwidth: int = 0
    num_cells: int = 0
    cells_processed: int = 0

    def has_node(self, node: int) -> bool:
        return node in self.rows

    def get_value(self, graph: AlignmentGraph, row: int, pos: int) -> int:
        """Score at (row within slice, graph position)."""
        node = graph.index_to_node(pos)
        return int(self.rows[node][row, pos - graph.node_start[node]])

    def get_value_or_max(self, graph: AlignmentGraph, row: int, pos: int, default) :
        node = graph.index_to_node(pos)
        if node not in self.rows:
            return default
        return int(self.rows[node][row, pos - graph.node_start[node]])

    def node_end_score(self, node: int) -> int:
        """Last cell's last-row score (reference: .back().scoreEnd)."""
        return int(self.rows[node][WORD_SIZE - 1, -1])


def make_initial_slice_one_node(graph: AlignmentGraph, node: int) -> SliceScores:
    """Initial band containing one node at score 0
    (reference getInitialSliceOnlyOneNode, GraphAligner.h:2945-2960)."""
    length = int(graph.node_len[node])
    return SliceScores(
        j=-WORD_SIZE,
        nodes=[node],
        sbs={node: np.zeros(length, dtype=np.int64)},
        sbs_exists={node: np.zeros(length, dtype=bool)},
        rows={node: np.zeros((WORD_SIZE, length), dtype=np.int64)},
        end_exists={node: np.ones(length, dtype=bool)},
        min_score=0,
        min_score_index=[int(graph.node_end[node]) - 1],
        node_min={node: 0},
    )


def _banded_tarjan(graph: AlignmentGraph, band_order: list, in_band: dict):
    """Tarjan SCC over the banded subgraph, replicating the reference's
    iteration order (roots in band order, out-neighbors in adjacency
    order); components emitted sinks-first (GraphAligner.h:1751-1901)."""
    index: dict = {}
    lowlink: dict = {}
    on_stack: set = set()
    stack: list = []
    components: list = []
    counter = [0]

    for root in band_order:
        if root in index:
            continue
        work = [(root, 0)]
        index[root] = lowlink[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, cursor = work[-1]
            neighbors = graph.out_neighbors(v)
            advanced = False
            while cursor < len(neighbors):
                w = int(neighbors[cursor])
                cursor += 1
                if w not in in_band:
                    continue
                if w not in index:
                    work[-1] = (v, cursor)
                    index[w] = lowlink[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, 0))
                    advanced = True
                    break
                elif w in on_stack:
                    if index[w] < lowlink[v]:
                        lowlink[v] = index[w]
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                if lowlink[v] < lowlink[parent]:
                    lowlink[parent] = lowlink[v]
            if lowlink[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                components.append(comp)
    return components


def _match_rows(sequence: str, j: int):
    """Per-row × per-base match masks: BA/BT/BC/BG of the reference
    (GraphAligner.h:2337-2351), with full IUPAC read-side degeneracy.
    Rows beyond the sequence end never match (reference leaves those Eq
    bits zero)."""
    out = np.zeros((WORD_SIZE, 4), dtype=bool)
    for r in range(WORD_SIZE):
        if j + r >= len(sequence):
            break
        matches = IUPAC_MATCHES.get(sequence[j + r].upper())
        if matches is None:
            raise ValueError(f"unsupported read character {sequence[j + r]!r}")
        for b in range(4):
            out[r, b] = _CODE_TO_CHAR[b] in matches
    return out


def compute_slice(
    graph: AlignmentGraph,
    sequence: str,
    j: int,
    band_nodes: list,
    prev: SliceScores,
    slice_index: int,
    bandwidth: int,
) -> SliceScores:
    """Compute one 64-row slice over band_nodes given the previous slice."""
    band_set = {int(n): True for n in band_nodes}
    prev_set = set(prev.nodes)
    match = _match_rows(sequence, j)
    seq_len_plus1 = len(sequence) + 1

    # --- local cell indexing over the band ---------------------------------
    cell_pos = []  # graph position of each band cell
    node_first: dict = {}
    node_len: dict = {}
    for n in band_nodes:
        n = int(n)
        node_first[n] = len(cell_pos)
        L = int(graph.node_len[n])
        node_len[n] = L
        start = int(graph.node_start[n])
        cell_pos.extend(range(start, start + L))
    C = len(cell_pos)
    cell_pos = np.array(cell_pos, dtype=np.int64)
    codes = graph.seq_codes[cell_pos]

    # horizontal predecessor structure: list of (to_cell, from_cell)
    chain_from = np.arange(-1, C - 1, dtype=np.int64)  # within-node default
    for n in band_nodes:
        n = int(n)
        chain_from[node_first[n]] = -1
    # node-start in-edges from banded neighbors, and pseudo seeds from
    # previous-band-only neighbors
    start_preds: dict = {}  # cell -> list of pred cells (banded)
    pseudo_preds: dict = {}  # cell -> list of old end scores
    band_sources = []
    for n in band_nodes:
        n = int(n)
        first = node_first[n]
        preds = []
        pseudos = []
        any_banded = False
        for nb in graph.in_neighbors(n):
            nb = int(nb)
            in_cur = nb in band_set
            in_prev = nb in prev_set
            if in_cur:
                preds.append(node_first[nb] + node_len[nb] - 1)
                any_banded = True
            if in_prev:
                any_banded = True
                if not in_cur:
                    pseudos.append(prev.node_end_score(nb))
        if preds:
            start_preds[first] = preds
        if pseudos:
            pseudo_preds[first] = pseudos
        if not any_banded:
            band_sources.append(n)

    # --- row j-1 (scoreBeforeStart) min-closure ----------------------------
    sbs = np.full(C, BIG, dtype=np.int64)
    old_end = np.full(C, BIG, dtype=np.int64)  # previous slice last-row scores
    old_end_exists = np.zeros(C, dtype=bool)
    in_prev_band = np.zeros(C, dtype=bool)
    for n in band_nodes:
        n = int(n)
        if n in prev_set:
            f = node_first[n]
            L = node_len[n]
            old_end[f : f + L] = prev.rows[n][WORD_SIZE - 1]
            old_end_exists[f : f + L] = prev.end_exists[n]
            in_prev_band[f : f + L] = True
            sbs[f : f + L] = prev.rows[n][WORD_SIZE - 1]
    # pseudo seeds at node starts (previous-band-only in-neighbors)
    for cell, olds in pseudo_preds.items():
        for o in olds:
            sbs[cell] = min(sbs[cell], o + 1)
    # band-source nodes absent from previous band: len+1 chain
    # (reference getSourceSliceWithoutBefore, GraphAligner.h:1317-1320)
    for n in band_sources:
        if n not in prev_set:
            f = node_first[n]
            sbs[f] = min(sbs[f], seq_len_plus1)
    # read-row x cell match; code 4 (dummy '-') never matches (reference
    # EqVector.getEq returns 0 for non-ACGT in NDEBUG, GraphAligner.h:93-98)
    match_ext = np.zeros((WORD_SIZE, 5), dtype=bool)
    match_ext[:, :4] = match
    match_cell = match_ext[:, codes]  # [64, C]

    # ---- native fast path (the giant-band method) --------------------------
    # For big bands (>= 512 cells; the reference's alternate-method regime
    # reaches 200k bp) the closures + 64-row loop run in C++ with Dial
    # bucket queues (native/ga_native.cpp::ga_compute_slice) — identical
    # values, ~1000x the Python loop below, which remains the behavioral
    # specification and the small-band path.
    native_res = None
    if C >= NATIVE_MIN_CELLS:
        native_res = _native_slice(
            graph, band_nodes, band_set, node_first, node_len, cell_pos,
            chain_from, start_preds, pseudo_preds, band_sources, prev_set,
            match_cell, sbs, old_end, old_end_exists, in_prev_band,
            slice_index, C,
        )
    if native_res is not None:
        sbs, sbs_exists, rows = native_res
    else:
        # min-closure with +1 horizontal steps (Dijkstra)
        heap = [(int(sbs[c]), c) for c in range(C) if sbs[c] < BIG]
        heapq.heapify(heap)
        dist = sbs.copy()
        while heap:
            d, c = heapq.heappop(heap)
            if d > dist[c]:
                continue
            nxts = []
            if c + 1 < C and chain_from[c + 1] == c:
                nxts.append(c + 1)
            # node-last cell: edges to banded successors' first cells
            pos = cell_pos[c]
            node = graph.index_to_node(pos)
            if pos == graph.node_end[node] - 1:
                for nb in graph.out_neighbors(node):
                    nb = int(nb)
                    if nb in band_set:
                        nxts.append(node_first[nb])
            for t in nxts:
                nd = d + 1
                if nd < dist[t]:
                    dist[t] = nd
                    heapq.heappush(heap, (nd, t))
        sbs = dist
        sbs_exists = in_prev_band & (old_end == sbs) & old_end_exists

        # --- rows 0..63 -----------------------------------------------------
        rows = np.full((WORD_SIZE, C), BIG, dtype=np.int64)

        def horizontal_closure(vals: np.ndarray) -> np.ndarray:
            d = vals.copy()
            h = [(int(d[c]), c) for c in range(C) if d[c] < BIG]
            heapq.heapify(h)
            while h:
                dd, c = heapq.heappop(h)
                if dd > d[c]:
                    continue
                nxts = []
                if c + 1 < C and chain_from[c + 1] == c:
                    nxts.append(c + 1)
                pos = cell_pos[c]
                node = graph.index_to_node(pos)
                if pos == graph.node_end[node] - 1:
                    for nb in graph.out_neighbors(node):
                        nb = int(nb)
                        if nb in band_set:
                            nxts.append(node_first[nb])
                for t in nxts:
                    nd = dd + 1
                    if nd < d[t]:
                        d[t] = nd
                        heapq.heappush(h, (nd, t))
            return d

        prev_row = None
        for r in range(WORD_SIZE):
            if r == 0:
                cur = sbs + 1  # vertical from row j-1
                # diagonal from predecessor's row j-1: match costs 0 only when
                # the predecessor's sbs exists (== Eq&=~1 gating in getNextSlice)
                diag_src = sbs
                diag_exists = sbs_exists
            else:
                cur = prev_row + 1
                diag_src = prev_row
                diag_exists = None  # in-slice rows always allow matches
            # within-node diagonals and horizontals seeds (horizontal done in
            # closure; diagonal seeded here)
            shifted = np.empty(C, dtype=np.int64)
            shifted[1:] = diag_src[:-1]
            shifted[0] = BIG
            valid = chain_from >= 0
            if diag_exists is None:
                cost = np.where(match_cell[r], 0, 1)
            else:
                ex = np.empty(C, dtype=bool)
                ex[1:] = diag_exists[:-1]
                ex[0] = False
                cost = np.where(match_cell[r] & ex, 0, 1)
            cand = np.where(valid, shifted + cost, BIG)
            cur = np.minimum(cur, cand)
            # node-start diagonals from banded in-neighbors
            for cell, preds in start_preds.items():
                for pd in preds:
                    if diag_exists is None:
                        cost = 0 if match_cell[r, cell] else 1
                    else:
                        cost = 0 if (match_cell[r, cell] and diag_exists[pd]) else 1
                    cur[cell] = min(cur[cell], diag_src[pd] + cost)
            # pseudo columns from previous-band-only in-neighbors
            # (column value at row j+k is old+k+1; diagonal matches only row 0)
            for cell, olds in pseudo_preds.items():
                for o in olds:
                    if r == 0:
                        cost = 0 if match_cell[0, cell] else 1
                        cur[cell] = min(cur[cell], o + cost)
                    else:
                        cur[cell] = min(cur[cell], o + r + 1)
            # free-start diagonal for band-source nodes in the previous band at
            # the very first slice (== getSourceSliceFromStartMatch)
            if r == 0 and slice_index == 0:
                for n in band_sources:
                    if n in prev_set:
                        f = node_first[n]
                        cost = 0 if match_cell[0, f] else 1
                        cur[f] = min(cur[f], sbs[f] + cost)
            cur = horizontal_closure(cur)
            rows[r] = cur
            prev_row = cur

    # --- package ------------------------------------------------------------
    out_sbs, out_sbs_e, out_rows, out_ee, node_min = {}, {}, {}, {}, {}
    for n in band_nodes:
        n = int(n)
        f = node_first[n]
        L = node_len[n]
        out_sbs[n] = sbs[f : f + L].copy()
        out_sbs_e[n] = sbs_exists[f : f + L].copy()
        out_rows[n] = rows[:, f : f + L].copy()
        out_ee[n] = np.ones(L, dtype=bool)
        node_min[n] = int(rows[WORD_SIZE - 1, f : f + L].min())

    # minScore / minScoreIndex in the reference's processing order:
    # components sinks-first-emitted → processed in reverse (sources first),
    # nodes popped LIFO within a component (GraphAligner.h:2359-2366,
    # UniqueQueue.h). Collection order matters only for tie-breaking of the
    # backtrace start (minScoreIndex.back()).
    components = _banded_tarjan(graph, [int(n) for n in band_nodes], band_set)
    min_score = None
    min_index: list = []
    for comp in reversed(components):
        for n in reversed(comp):
            nm = node_min[n]
            if min_score is None or nm < min_score:
                min_score = nm
                min_index = []
            if nm == min_score:
                f = node_first[n]
                L = node_len[n]
                start = int(graph.node_start[n])
                for k in range(L):
                    if rows[WORD_SIZE - 1, f + k] == nm:
                        min_index.append(start + k)

    return SliceScores(
        j=j,
        nodes=[int(n) for n in band_nodes],
        sbs=out_sbs,
        sbs_exists=out_sbs_e,
        rows=out_rows,
        end_exists=out_ee,
        min_score=int(min_score),
        min_score_index=min_index,
        node_min=node_min,
        bandwidth=bandwidth,
        num_cells=C,
        cells_processed=C * WORD_SIZE,
    )


def _native_slice(graph, band_nodes, band_set, node_first, node_len, cell_pos,
                  chain_from, start_preds, pseudo_preds, band_sources,
                  prev_set, match_cell, seed_sbs, old_end, old_end_exists,
                  in_prev_band, slice_index, C):
    """Build the flat arrays for native.compute_slice_rows."""
    from . import native

    chain = (chain_from >= 0).astype(np.uint8)
    # cross-edges: node-last cell -> banded successors' first cells (CSR)
    edge_ptr = np.zeros(C + 1, dtype=np.int64)
    froms: list = []
    tos: list = []
    for n in band_nodes:
        n = int(n)
        last = node_first[n] + node_len[n] - 1
        for nb in graph.out_neighbors(n):
            nb = int(nb)
            if nb in band_set:
                froms.append(last)
                tos.append(node_first[nb])
    froms_a = np.asarray(froms, dtype=np.int64)
    tos_a = np.asarray(tos, dtype=np.int32)
    order = np.argsort(froms_a, kind="stable")
    froms_a = froms_a[order]
    tos_a = tos_a[order]
    np.add.at(edge_ptr, froms_a + 1, 1)
    edge_ptr = np.cumsum(edge_ptr)
    sp_cell = []
    sp_pred = []
    for cell, preds in start_preds.items():
        for pd in preds:
            sp_cell.append(cell)
            sp_pred.append(pd)
    ps_cell = []
    ps_old = []
    for cell, olds in pseudo_preds.items():
        for o in olds:
            ps_cell.append(cell)
            ps_old.append(int(o))
    fs_cell = [
        node_first[n] for n in band_sources if n in prev_set
    ]
    old_flags = (
        old_end_exists.astype(np.uint8) | (in_prev_band.astype(np.uint8) << 1)
    )
    return native.compute_slice_rows(
        chain, edge_ptr, tos_a, sp_cell, sp_pred, ps_cell, ps_old, fs_cell,
        match_cell, seed_sbs, old_end, old_flags, slice_index,
    )
