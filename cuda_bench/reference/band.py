# Frozen copy of graphaligner_tpu_torch/core/band.py, part of the benchmark's plain reference (imports nothing of the program).
"""Score-based band projection between slices.

Replicates projectForwardFromMinScore (reference GraphAligner.h:1110-1159):
seed the next band with previous-slice nodes whose min score is within
``bandwidth`` of the slice minimum, then Dijkstra forward over out-edges
up to ``bandwidth + 64`` extra score, truncating once the band reaches
ALTERNATE_METHOD_CUTOFF bp.
"""

from __future__ import annotations

import heapq

from .graph import AlignmentGraph
from .oracle import SliceScores
from .params import ALTERNATE_METHOD_CUTOFF, WORD_SIZE


def project_forward_from_min_score(
    graph: AlignmentGraph, prev: SliceScores, bandwidth: int
) -> list:
    expand_width = bandwidth + WORD_SIZE
    min_score = prev.min_score
    distances: dict = {}
    result: list = []
    heap: list = []
    counter = 0
    current_width = 0
    for node in prev.nodes:
        if prev.node_min[node] <= min_score + bandwidth:
            distances[node] = 0
            result.append(node)
            current_width += int(graph.node_len[node])
            if current_width >= ALTERNATE_METHOD_CUTOFF:
                return result
            end_score = prev.node_end_score(node)
            if end_score > min_score + expand_width:
                continue
            for nb in graph.out_neighbors(node):
                counter += 1
                heapq.heappush(heap, (end_score - min_score + 1, counter, int(nb)))
    assert distances
    while heap:
        priority, _, node = heapq.heappop(heap)
        if priority > expand_width:
            break
        if node in distances and distances[node] <= priority:
            continue
        current_width += int(graph.node_len[node])
        distances[node] = priority
        result.append(node)
        if current_width >= ALTERNATE_METHOD_CUTOFF:
            return result
        size = int(graph.node_len[node])
        for nb in graph.out_neighbors(node):
            counter += 1
            heapq.heappush(heap, (priority + size, counter, int(nb)))
    return result


def project_forward_from_arrays(
    graph: AlignmentGraph,
    nodes,
    node_min,
    node_end,
    min_score: int,
    bandwidth: int,
) -> list:
    """project_forward_from_min_score fed by parallel arrays instead of a
    SliceScores object: ``nodes`` in the previous band's insertion order
    with per-node min/end scores. Identical traversal (seeding order, heap
    counters, truncation) — used by the batched pipeline's band-order
    replay, where per-slice dict building dominated."""
    expand_width = bandwidth + WORD_SIZE
    qual = min_score + bandwidth
    exp = min_score + expand_width
    distances: dict = {}
    result: list = []
    heap: list = []
    counter = 0
    current_width = 0
    node_len = graph.node_len
    for node, nmin, nend in zip(nodes, node_min, node_end):
        if nmin <= qual:
            node = int(node)
            distances[node] = 0
            result.append(node)
            current_width += int(node_len[node])
            if current_width >= ALTERNATE_METHOD_CUTOFF:
                return result
            if nend > exp:
                continue
            pri = int(nend) - min_score + 1
            for nb in graph.out_neighbors(node):
                counter += 1
                heapq.heappush(heap, (pri, counter, int(nb)))
    assert distances
    while heap:
        priority, _, node = heapq.heappop(heap)
        if priority > expand_width:
            break
        if node in distances and distances[node] <= priority:
            continue
        current_width += int(node_len[node])
        distances[node] = priority
        result.append(node)
        if current_width >= ALTERNATE_METHOD_CUTOFF:
            return result
        size = int(node_len[node])
        for nb in graph.out_neighbors(node):
            counter += 1
            heapq.heappush(heap, (priority + size, counter, int(nb)))
    return result
