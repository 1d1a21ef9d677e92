# Copy of graphaligner_tpu/tools/extract_path_sequence.py for the torch port (imports point at graphaligner_tpu_torch).
"""Print each alignment path's graph-side sequence as FASTA (reference
ExtractPathSequence.cpp). Usage: graph.{vg,gfa} alignments.gam
"""

from __future__ import annotations

import sys

from ..io.gfa import GfaGraph
from ..io.sequences import reverse_complement
from ._common import load_alignments, load_vg_graph


def print_path(get_seq, alignment, out):
    out.write(f">{alignment.name}\n")
    parts = []
    for m in alignment.path.mapping:
        sequence = get_seq(m.position.node_id)
        length = sum(e.from_length for e in m.edit)
        if m.position.is_reverse:
            sequence = reverse_complement(sequence)
        if m.position.offset > 0:
            sequence = sequence[m.position.offset :]
        parts.append(sequence[:length])
    out.write("".join(parts) + "\n")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    graph_path = argv[0]
    if graph_path.endswith(".vg"):
        graph = load_vg_graph(graph_path)
        seqs = {n.id: n.sequence for n in graph.node}
    elif graph_path.endswith(".gfa"):
        seqs = GfaGraph.load(graph_path).nodes
    else:
        print(f"unknown graph format: {graph_path}", file=sys.stderr)
        return 1
    for a in load_alignments(argv[1]):
        print(a.name, file=sys.stderr)
        print_path(lambda nid: seqs[nid], a, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
