# Copy of graphaligner_tpu/tools/extract_path_subgraph_neighbourhood.py for the torch port (imports point at graphaligner_tpu_torch).
"""Dijkstra ball of bp radius ``length`` around an alignment path; saves
the touched subgraph as GFA (reference
ExtractPathSubgraphNeighbourhood.cpp).
Usage: in.gfa out.gfa alignment.gam length
"""

from __future__ import annotations

import heapq
import sys

from ..io.gfa import GfaGraph
from ._common import load_alignments


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    graph = GfaGraph.load(argv[0])
    alignments = load_alignments(argv[2])
    alignment = alignments[-1] if alignments else None
    length = int(argv[3])
    print(f"length: {length}", file=sys.stderr)
    heap = []
    counter = 0
    for m in alignment.path.mapping:
        heapq.heappush(heap, (0, counter, (m.position.node_id, m.position.is_reverse)))
        counter += 1
    distance: dict = {}
    while heap:
        prio, _, pos = heapq.heappop(heap)
        if prio > length:
            break
        if pos in distance and distance[pos] <= prio:
            continue
        distance[pos] = prio
        for edge in graph.edges.get(pos, []):
            step = len(graph.nodes[pos[0]]) - graph.edge_overlap
            counter += 1
            heapq.heappush(heap, (prio + step, counter, edge))
    picked = {pos[0] for pos in distance}
    print(len(picked), file=sys.stderr)
    graph.subgraph(picked).save(argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
