# Copy of graphaligner_tpu/io/fastq.py for the torch port (the native parser only, no pure-Python fallback).
"""FASTA/FASTQ loading (reference: fastqloader.cpp).

Format selected by extension (.fastq/.fq → FASTQ, .fasta/.fa → FASTA,
fastqloader.cpp:63-70); CRLF tolerant; FASTA records get '!' qualities
(fastqloader.cpp:54-57). Multi-line FASTA sequences are concatenated.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .sequences import reverse_complement


@dataclass
class FastQ:
    seq_id: str = ""
    sequence: str = ""
    quality: str = ""

    def reverse_complement(self) -> "FastQ":
        return FastQ(
            seq_id=self.seq_id,
            sequence=reverse_complement(self.sequence),
            quality=self.quality[::-1],
        )


def load_fastq(path: str) -> list[FastQ]:
    """Load reads, format keyed by extension; unknown extensions → [].
    Parsed by the native library (io.native)."""
    if path.endswith(".fastq") or path.endswith(".fq"):
        is_fasta = False
    elif path.endswith(".fasta") or path.endswith(".fa"):
        is_fasta = True
    else:
        return []
    from . import native

    with open(path, "rb") as f:
        data = f.read()
    return [FastQ(seq_id=n, sequence=s, quality=q)
            for n, s, q in native.parse_reads(data, is_fasta)]
