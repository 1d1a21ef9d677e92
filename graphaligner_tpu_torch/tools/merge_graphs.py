# Copy of graphaligner_tpu/tools/merge_graphs.py for the torch port (imports point at graphaligner_tpu_torch).
"""Concatenate vg graphs (reference MergeGraphs.cpp, generalized beyond
its hard-coded four inputs). Usage: in1.vg [in2.vg ...] [-o out.vg]
(default output: finalaugmentedgraph.vg, as the reference)
"""

from __future__ import annotations

import sys

from ..io import stream, vg
from ._common import load_vg_graph


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    out_path = "finalaugmentedgraph.vg"
    if "-o" in argv:
        i = argv.index("-o")
        out_path = argv[i + 1]
        del argv[i : i + 2]
    merged = vg.Graph()
    for path in argv:
        g = load_vg_graph(path)
        for n in g.node:
            merged.node.append(vg.Node(id=n.id, sequence=n.sequence, name=n.name))
        for e in g.edge:
            merged.edge.append(
                vg.Edge(
                    from_=e.from_, to=e.to, from_start=e.from_start,
                    to_end=e.to_end, overlap=e.overlap,
                )
            )
    stream.write_messages(out_path, [merged])
    return 0


if __name__ == "__main__":
    sys.exit(main())
