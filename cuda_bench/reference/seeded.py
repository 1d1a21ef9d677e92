"""One read through the reference, as the program's output shows it.

``align`` runs the scalar seeded path (reference AlignOneWay, seeded
banded mode) and returns what the CLI keeps of a read: whether it failed,
its GAM message as bytes (node ids back on the bigraph, as the CLI writes
them) and its band cell count.
"""

from __future__ import annotations

from dataclasses import dataclass

from .align import align_one_way_seeded
from .graph import AlignmentGraph
from .result import INT32_MAX


@dataclass(frozen=True)
class Answer:
    failed: bool
    payload: bytes | None
    cells: int


def load_graph(handed: dict) -> AlignmentGraph:
    """The reference's graph from what the benchmark handed to both sides:
    ``{"arrays": (node_ids, reverse, node_len, seq_codes, edge_from,
    edge_to)}``."""
    return AlignmentGraph.from_arrays(*handed["arrays"])


def align(graph: AlignmentGraph, name: str, sequence: str, seeds: list,
          initial_bandwidth: int, ramp_bandwidth: int) -> Answer:
    r = align_one_way_seeded(graph, name, sequence, initial_bandwidth,
                             ramp_bandwidth, seeds)
    if r.alignment_failed or r.alignment.score == INT32_MAX:
        return Answer(True, None, 0)
    for m in r.alignment.path.mapping:
        m.position.node_id //= 2
    return Answer(False, r.alignment.encode(), int(r.cells_processed))
