# Frozen copy of graphaligner_tpu_torch/core/hmm.py, part of the benchmark's plain reference (imports nothing of the program).
"""2-state alignment-correctness HMM.

Per 64-row slice, the increase in minimum score ("mismatches") feeds a
correct/false HMM with binomial emissions (p=0.2 correct / p=0.5 false)
and asymmetric transitions; used to stop extension, trigger bandwidth
ramping, and trim wrongly-aligned tails
(reference: AlignmentCorrectnessEstimation.cpp:6-89).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

_CORRECT_MISMATCH = math.log(0.2)
_CORRECT_MATCH = math.log(1.0 - 0.2)
_FALSE_MISMATCH = math.log(0.5)
_FALSE_MATCH = math.log(1.0 - 0.5)
_FALSE_TO_CORRECT = math.log(0.00001)
_FALSE_TO_FALSE = math.log(1.0 - 0.00001)
_CORRECT_TO_FALSE = math.log(0.000000000000001)
_CORRECT_TO_CORRECT = math.log(1.0 - 0.000000000000001)

_LOG_FACTORIALS = [0.0]
for _i in range(1, 65):
    _LOG_FACTORIALS.append(_LOG_FACTORIALS[-1] + math.log(_i))


def _log_choose(n: int, k: int) -> float:
    return _LOG_FACTORIALS[n] - _LOG_FACTORIALS[k] - _LOG_FACTORIALS[n - k]


@dataclass(frozen=True)
class CorrectnessState:
    correct_log_odds: float = math.log(0.8)
    false_log_odds: float = math.log(0.2)
    correct_from_correct_trace: bool = False
    false_from_correct_trace: bool = False

    def currently_correct(self) -> bool:
        return self.correct_log_odds > self.false_log_odds

    def correct_from_correct(self) -> bool:
        return self.correct_from_correct_trace

    def false_from_correct(self) -> bool:
        return self.false_from_correct_trace

    def next_state(self, mismatches: int, row_size: int = 64) -> "CorrectnessState":
        assert 0 <= mismatches <= row_size
        cfc = (
            self.correct_log_odds + _CORRECT_TO_CORRECT
            >= self.false_log_odds + _FALSE_TO_CORRECT
        )
        ffc = (
            self.correct_log_odds + _CORRECT_TO_FALSE
            >= self.false_log_odds + _FALSE_TO_FALSE
        )
        new_correct = max(
            self.correct_log_odds + _CORRECT_TO_CORRECT,
            self.false_log_odds + _FALSE_TO_CORRECT,
        )
        new_false = max(
            self.correct_log_odds + _CORRECT_TO_FALSE,
            self.false_log_odds + _FALSE_TO_FALSE,
        )
        choose = _log_choose(row_size, mismatches)
        new_correct += (
            choose
            + mismatches * _CORRECT_MISMATCH
            + (row_size - mismatches) * _CORRECT_MATCH
        )
        new_false += (
            choose
            + mismatches * _FALSE_MISMATCH
            + (row_size - mismatches) * _FALSE_MATCH
        )
        return CorrectnessState(new_correct, new_false, cfc, ffc)
