# Frozen copy of graphaligner_tpu_torch/core/result.py, part of the benchmark's plain reference (imports nothing of the program).
"""Alignment result type (reference GraphAlignerWrapper.h:11-50)."""

from __future__ import annotations

from dataclasses import dataclass, field

from . import vg

INT32_MAX = 2**31 - 1


@dataclass
class AlignmentResult:
    alignment: vg.Alignment = field(default_factory=vg.Alignment)
    alignment_failed: bool = True
    cells_processed: int = 0
    elapsed_milliseconds: int = 0
    alignment_start: int = 0
    alignment_end: int = 0
    trace: list = field(default_factory=list)


def empty_alignment(elapsed_ms: int, cells_processed: int) -> AlignmentResult:
    aln = vg.Alignment(score=INT32_MAX)
    return AlignmentResult(
        alignment=aln,
        alignment_failed=True,
        cells_processed=cells_processed,
        elapsed_milliseconds=elapsed_ms,
    )
