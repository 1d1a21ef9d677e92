# Copy of graphaligner_tpu/tools/merge_gfas.py for the torch port (imports point at graphaligner_tpu_torch).
"""Union of GFA files (reference MergeGfas.cpp).
Usage: out.gfa in1.gfa [in2.gfa ...]
"""

from __future__ import annotations

import sys

from ..io.gfa import GfaGraph


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    graph = GfaGraph.load(argv[1])
    for path in argv[2:]:
        graph.add_subgraph(GfaGraph.load(path))
    graph.save(argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
