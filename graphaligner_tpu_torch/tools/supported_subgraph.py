# Copy of graphaligner_tpu/tools/supported_subgraph.py for the torch port (imports point at graphaligner_tpu_torch).
"""Keep only graph edges supported by at least one alignment (reference
SupportedSubgraph.cpp). Usage: graph.vg alignments.gam out.vg
"""

from __future__ import annotations

import sys

from ..io import stream, vg
from ._common import load_alignments, load_vg_graph


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    graph = load_vg_graph(argv[0])
    alignments = load_alignments(argv[1])
    existing: dict = {}
    for e in graph.edge:
        existing.setdefault(e.from_, set()).add(e.to)
    supported: dict = {}
    for a in alignments:
        print(f"alignment {a.name}")
        maps = a.path.mapping
        for j in range(len(maps) - 1):
            frm = maps[j].position.node_id
            to = maps[j + 1].position.node_id
            if to not in existing.get(frm, set()) and frm not in existing.get(
                to, set()
            ):
                print(f"nonexistant alignment from {frm} to {to}")
            supported.setdefault(frm, set()).add(to)
    result = vg.Graph()
    for n in graph.node:
        result.node.append(vg.Node(id=n.id, sequence=n.sequence, name=n.name))
    for e in graph.edge:
        fwd = e.to in supported.get(e.from_, set())
        bwd = e.from_ in supported.get(e.to, set())
        if not fwd and not bwd:
            continue
        result.edge.append(
            vg.Edge(
                from_=e.from_, to=e.to, from_start=e.from_start,
                to_end=e.to_end, overlap=e.overlap,
            )
        )
    stream.write_messages(argv[2], [result])
    return 0


if __name__ == "__main__":
    sys.exit(main())
