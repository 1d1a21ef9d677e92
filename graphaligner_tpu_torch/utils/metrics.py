# Copy of graphaligner_tpu/utils/metrics.py for the torch port (imports point at graphaligner_tpu_torch).
"""Alignment metrics (the reference's self-instrumentation hooks:
per-read elapsed ms and DP cells processed, GraphAlignerWrapper.h:46-47,
GraphAligner.h:391-404, plus batch-level throughput)."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


@dataclass
class AlignMetrics:
    reads: int = 0
    failed: int = 0
    cells_processed: int = 0
    elapsed_s: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.time()
        return self

    def stop(self):
        self.elapsed_s += time.time() - self._t0
        return self

    def record_read(self, cells: int, failed: bool = False):
        self.reads += 1
        self.cells_processed += cells
        if failed:
            self.failed += 1

    def summary(self) -> dict:
        return {
            "reads": self.reads,
            "failed": self.failed,
            "cells_processed": self.cells_processed,
            "elapsed_s": round(self.elapsed_s, 3),
            "reads_per_s": round(self.reads / self.elapsed_s, 1)
            if self.elapsed_s
            else None,
            "gcells_per_s": round(self.cells_processed / self.elapsed_s / 1e9, 3)
            if self.elapsed_s
            else None,
        }

    def json_line(self) -> str:
        return json.dumps(self.summary())
