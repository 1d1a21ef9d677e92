# Copy of graphaligner_tpu/tools/alignment_overlap.py for the torch port (imports point at graphaligner_tpu_torch).
"""Build a read-overlap GFA from alignments by exact node-movement
overlap (reference AlignmentOverlap.cpp; its NW-style DP variant,
getOverlaps, is defined but unused in the reference main and is provided
here behind --dp for completeness).
Usage: graph.vg alignments.gam minMatchFraction minSizeFraction reads.fastq out.gfa
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

from ..io.fastq import load_fastq
from ._common import load_alignments, load_vg_graph


@dataclass
class NodeMovement:
    node_id: int
    backwards: bool
    offset: int
    length: int

    def compatible(self, other) -> bool:
        """Reference NodeMovement::operator== — same node+orientation and
        one interval containing the other."""
        return (
            self.node_id == other.node_id
            and self.backwards == other.backwards
            and (
                (
                    self.offset <= other.offset
                    and self.offset + self.length >= other.offset + other.length
                )
                or (
                    other.offset <= self.offset
                    and other.offset + other.length >= self.offset + self.length
                )
            )
        )


@dataclass
class Overlap:
    readname1: str
    readname2: str
    length1: int
    length2: int
    backward1: bool
    backward2: bool


def get_node_movements(alignment):
    return [
        NodeMovement(
            node_id=m.position.node_id,
            backwards=m.position.is_reverse,
            offset=m.position.offset,
            length=m.edit[0].from_length if m.edit else 0,
        )
        for m in alignment.path.mapping
    ]


def reverse_movements(movements):
    return [
        NodeMovement(m.node_id, not m.backwards, m.offset, m.length)
        for m in reversed(movements)
    ]


def get_exact_overlaps(name1, read1, name2, read2, min_match_frac, min_size_frac, backward2):
    size1 = sum(m.length for m in read1)
    size2 = sum(m.length for m in read2)
    min_match = min(size1 * min_size_frac, size2 * min_size_frac)
    result = []
    i = 0
    while i < len(read1):
        if len(read1) >= len(read2) and i <= len(read1) - len(read2):
            i = len(read1) - len(read2) + 1
        match = True
        length = 0
        for k in range(len(read1) - i):
            if k >= len(read2):
                break
            if read1[i + k].compatible(read2[k]):
                length += min(read1[i + k].length, read2[k].length)
            else:
                match = False
                break
        if match and length > min_match:
            result.append(
                Overlap(name1, name2, length, length, False, backward2)
            )
            break
        i += 1
    return result


def alignment_possible(sizes, sorted_nodes, first, second, min_size_frac):
    min_size = min(sizes[first], sizes[second]) * min_size_frac
    i = j = size = 0
    a, b = sorted_nodes[first], sorted_nodes[second]
    while i < len(a) and j < len(b):
        if a[i].node_id < b[j].node_id:
            i += 1
        elif b[j].node_id < a[i].node_id:
            j += 1
        else:
            size += a[i].length
            i += 1
            j += 1
            if size >= min_size:
                return True
    return False


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    load_vg_graph(argv[0])  # parsed for parity; sizes unused by exact path
    alignments = load_alignments(argv[1])
    min_match_frac = float(argv[2])
    min_size_frac = float(argv[3])
    reads = load_fastq(argv[4])
    movements = [get_node_movements(a) for a in alignments]
    sizes = [sum(m.length for m in mv) for mv in movements]
    sorted_nodes = [
        sorted(
            [NodeMovement(m.node_id, False, m.offset, m.length) for m in mv],
            key=lambda m: m.node_id,
        )
        for mv in movements
    ]
    overlaps = []
    for i in range(len(alignments)):
        for j in range(len(alignments)):
            if not alignment_possible(sizes, sorted_nodes, i, j, min_size_frac):
                continue
            fw = get_exact_overlaps(
                alignments[i].name, movements[i], alignments[j].name,
                movements[j], min_match_frac, min_size_frac, False,
            )
            bw = get_exact_overlaps(
                alignments[i].name, movements[i], alignments[j].name,
                reverse_movements(movements[j]), min_match_frac, min_size_frac, True,
            )
            overlaps = fw + bw + overlaps
    with open(argv[5], "w") as f:
        for r in reads:
            f.write(f"S\t{r.seq_id}\t{r.sequence}\n")
        for ov in overlaps:
            f.write(
                f"L\t{ov.readname1}\t{'-' if ov.backward1 else '+'}"
                f"\t{ov.readname2}\t{'-' if ov.backward2 else '+'}"
                f"\t{ov.length1}M\n"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
