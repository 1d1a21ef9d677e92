# Copy of graphaligner_tpu/tools/read_index_to_id.py for the torch port (imports point at graphaligner_tpu_torch).
"""CSV (nodeid, readindex, readpos) seed hits → seed GAM (reference
ReadIndexToId.cpp; input from an external minimizer tool).
Usage: reads.fastq hits.csv seeds.gam [1 for reverse coordinates]
"""

from __future__ import annotations

import sys

from ..io import vg
from ..io.fastq import load_fastq
from ._common import write_alignments


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    fastqs = load_fastq(argv[0])
    reverse = len(argv) > 3 and argv[3].startswith("1")
    output = []
    existing = set()
    with open(argv[1]) as f:
        for line in f:
            line = line.strip()
            if not line:
                break
            parts = line.split(",")
            node_id, read_id, read_pos = int(parts[0]), int(parts[1]), int(parts[2])
            if (node_id, read_id) in existing:
                continue
            existing.add((node_id, read_id))
            qpos = (
                len(fastqs[read_id].sequence) - read_pos - 1 if reverse else read_pos
            )
            output.append(
                vg.Alignment(
                    name=fastqs[read_id].seq_id,
                    query_position=qpos,
                    path=vg.Path(
                        mapping=[vg.Mapping(position=vg.Position(node_id=node_id))]
                    ),
                )
            )
    write_alignments(argv[2], output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
