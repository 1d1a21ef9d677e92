# Copy of graphaligner_tpu/tools/pick_seed_hits.py for the torch port (imports point at graphaligner_tpu_torch).
"""Merge seed GAMs, dedup by (node, query position), cap per read
(reference PickSeedHits.cpp). Usage: out.gam maxseeds in1.gam [in2.gam...]
"""

from __future__ import annotations

import sys

from ._common import load_alignments, write_alignments


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    out_path, max_seeds = argv[0], int(argv[1])
    by_name: dict = {}
    for path in argv[2:]:
        for a in load_alignments(path):
            node_id = a.path.mapping[0].position.node_id
            if node_id <= 1:
                continue
            existing = by_name.setdefault(a.name, [])
            if any(
                e.path.mapping[0].position.node_id == node_id
                and e.query_position == a.query_position
                for e in existing
            ):
                continue
            if len(existing) < max_seeds:
                existing.append(a)
    out = [a for name in sorted(by_name) for a in by_name[name]]
    write_alignments(out_path, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
