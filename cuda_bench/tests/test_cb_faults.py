"""The comparison that decides ``correct`` fails what it must: with the
timed path broken underneath, a run drives on and reports ``correct``
false; the control (the reference at a band one narrower, in the
program's place) reads above the limits on every seed."""

import pytest

from cuda_bench import bench, check
from cuda_bench.control import readings
from cuda_bench.tests.tiny import tiny_cell

QUIET = {"log": lambda *a, **k: None}


def run(cell, seed=4):
    return bench.measure(cell, seed, 0.01, False, "cpu", 0.0, **QUIET)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    """Every read's score one higher as the batched aligner returns it."""
    from graphaligner_tpu_torch.core import batch_align

    orig = batch_align.align_reads_seeded_batch

    def altered(*a, **k):
        out = orig(*a, **k)
        for res in out.values():
            if not res.alignment_failed:
                res.alignment.score += 1
        return out

    monkeypatch.setattr(batch_align, "align_reads_seeded_batch", altered)
    out = run(tiny_cell())
    assert out["correct"] is False
    assert out["checks"]["gam_mismatch"]["value"] > 0


def test_half_of_the_batch_left_out(monkeypatch):
    """The aligner returns the first half of each call's reads only."""
    from graphaligner_tpu_torch.core import batch_align

    orig = batch_align.align_reads_seeded_batch

    def half(graph, aligner, reads, seeds, *a, **k):
        return orig(graph, aligner, reads[: len(reads) // 2], seeds, *a, **k)

    monkeypatch.setattr(batch_align, "align_reads_seeded_batch", half)
    out = run(tiny_cell())
    assert out["correct"] is False
    assert out["checks"]["missing_reads"]["value"] == 2
    assert out["failed"] == 2


def test_a_trace_shifted_in_the_walk(monkeypatch):
    """The walk's traces handed to finalize a position off."""
    from graphaligner_tpu_torch.io import native

    orig = native.TracePieceCtx.piece

    def shifted(self, trace, *a, **k):
        trace = trace.copy()
        if len(trace) > 2:
            trace[1:, 0] = trace[:-1, 0]
        return orig(self, trace, *a, **k)

    monkeypatch.setattr(native.TracePieceCtx, "piece", shifted)
    out = run(tiny_cell())
    assert out["correct"] is False


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 3_000_000_007])
def test_the_control_reads_above_the_limits(seed):
    """The reference at -b 34 in the place of the program at -b 35: the
    cell counts of its bands differ (``cells_mismatch``), where the
    reference against itself reads 0."""
    cell = tiny_cell(device_batch=8, read_len={"min": 1500, "max": 2000},
                     check_reads=8)
    got = readings(cell, seed, 1, "cpu")
    assert got["missing_reads"] == 0
    assert got["gam_mismatch"] + got["cells_mismatch"] > check.LIMITS[
        "cells_mismatch"]
    same = readings(cell, seed, 1, "cpu", band_delta=0)
    assert same == {"missing_reads": 0, "gam_mismatch": 0,
                    "cells_mismatch": 0}
