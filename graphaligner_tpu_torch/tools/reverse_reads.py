# Copy of graphaligner_tpu/tools/reverse_reads.py for the torch port (imports point at graphaligner_tpu_torch).
"""Reverse-complement a FASTQ (reference ReverseReads.cpp).
Usage: in.fastq out.fastq
"""

from __future__ import annotations

import sys

from ..io.fastq import load_fastq


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    reads = load_fastq(argv[0])
    with open(argv[1], "w") as f:
        for read in reads:
            rc = read.reverse_complement()
            f.write(f"@{rc.seq_id}\n{rc.sequence}\n+\n{rc.quality}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
