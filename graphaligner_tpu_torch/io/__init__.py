# Copy of graphaligner_tpu/io/__init__.py for the torch port (imports point at graphaligner_tpu_torch).
"""Serialization & I/O layer (reference L0).

Submodules:
  wire      — protobuf wire-format primitives (varint, tags, zigzag)
  vg        — the vg ecosystem message schema (Graph, Alignment, ...)
  stream    — gzip varint-framed message streams (GAM files)
  fastq     — FASTA/FASTQ loading
  sequences — IUPAC-aware sequence utilities
  gfa       — standalone GFA graph model for tooling
"""

from .fastq import FastQ, load_fastq  # noqa: F401
from .sequences import reverse_complement  # noqa: F401
from .stream import read_messages, write_messages  # noqa: F401
from . import vg  # noqa: F401
