# Frozen copy of graphaligner_tpu_torch/core/params.py, part of the benchmark's plain reference (imports nothing of the program).
"""Engine parameters and tuning constants.

Constants mirror the reference (GraphAlignerCommon.h:8-15, WordSlice.h:13).
"""

from __future__ import annotations

from dataclasses import dataclass

WORD_SIZE = 64

# Band size in bp at which the sparse/alternate method replaces the
# bitvector method, and band projection truncates
# (reference GraphAlignerCommon.h:10, "empirically ... fastest cutoff for
# aligning ONT's to human DBG").
ALTERNATE_METHOD_CUTOFF = 200_000

# Cutoff for capturing backtrace overrides in the sqrt-slice pass
# (reference GraphAlignerCommon.h:15; must equal the alternate cutoff).
BACKTRACE_OVERRIDE_CUTOFF = ALTERNATE_METHOD_CUTOFF


@dataclass
class AlignerParams:
    """Driver parameters (reference Aligner.h:8-19, AlignerMain.cpp:31-65)."""

    graph_file: str = ""
    fastq_file: str = ""
    alignment_file: str = ""
    auggraph_file: str = ""
    seed_file: str = ""
    num_threads: int = 1
    initial_bandwidth: int = 0
    ramp_bandwidth: int = 0
    dynamic_row_start: int = 64  # parsed but unused, as in the reference
    initial_full_band: bool = False
