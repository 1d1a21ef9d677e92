# Copy of graphaligner_tpu/tools/compare_alignments.py for the torch port (imports point at graphaligner_tpu_torch).
"""Truth-vs-predicted scoring by node-set bp overlap (reference
CompareAlignments.cpp). Usage: truth.gam predicted.gam graph.vg
Prints per-read identity and good/bad counts (good if identity >= 0.7).
"""

from __future__ import annotations

import sys

from ._common import load_alignments, load_vg_graph, node_sizes


def alignment_identity(real, predicted, sizes):
    left = {m.position.node_id for m in real.path.mapping}
    right = {m.position.node_id for m in predicted.path.mapping}
    common_bp = sum(sizes[n] for n in left & right)
    false_neg = sum(sizes[m.position.node_id] for m in real.path.mapping) - common_bp
    false_pos = (
        sum(sizes[m.position.node_id] for m in predicted.path.mapping) - common_bp
    )
    return common_bp, false_neg, false_pos


def identity_percent(result):
    total = sum(result)
    return result[0] / total if total else 0.0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    sizes = node_sizes(load_vg_graph(argv[2]))
    real = {a.name: a for a in load_alignments(argv[0])}
    predicted = {a.name: a for a in load_alignments(argv[1])}
    good = bad = 0
    for name in sorted(real):
        if name not in predicted:
            bad += 1
            continue
        r, p = real[name], predicted[name]
        result = alignment_identity(r, p, sizes)
        ident = identity_percent(result)
        read_len = len(p.sequence)
        print(
            f"{name}: {result[0]}bp common, {result[1]}bp false negative, "
            f"{result[2]}bp false positive ({ident:g}) {p.score} mismatches, "
            f"read length {read_len} "
            f"({(p.score / read_len) if read_len else 0:g})"
        )
        if ident < 0.7:
            bad += 1
        else:
            good += 1
    for name in predicted:
        if name not in real:
            bad += 1
    print(f"good matches: {good}")
    print(f"bad matches: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
