# Copy of graphaligner_tpu/tools/alignment_sequence_inserter.py for the torch port (imports point at graphaligner_tpu_torch).
"""Fill Alignment.sequence from a FASTQ by read name (reference
AlignmentSequenceInserter.cpp). Usage: reads.fastq in.gam out.gam
"""

from __future__ import annotations

import sys

from ..io.fastq import load_fastq
from ._common import load_alignments, write_alignments


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    reads = {r.seq_id: r for r in load_fastq(argv[0])}
    alignments = load_alignments(argv[1])
    for a in alignments:
        if a.name in reads:
            a.sequence = reads[a.name].sequence
    write_alignments(argv[2], alignments)
    return 0


if __name__ == "__main__":
    sys.exit(main())
