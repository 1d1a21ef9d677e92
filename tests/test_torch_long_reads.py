"""The port's memory-bounded long-read mode against the JAX package's.

Long mode chains scan rounds of one window each, drops each round's packed
columns once the control replay no longer needs them, and walks the
backtrace a window at a time, newest first, recomputing each round's
columns. On the CPU the sim reads (8 to 10 slices) are forced into it with
a window of 4 or 2 slices; the longsim-sized corpora run on the card
(tests/test_torch_cuda.py, chip_smoke.py). All comparisons are exact.
"""

import pathlib

import numpy as np
import pytest
import torch

import graphaligner_tpu.core.batch_align as jba
import graphaligner_tpu.ops.pallas.walk_moves as jwm
import graphaligner_tpu_torch.core.batch_align as tba
import graphaligner_tpu_torch.ops.walk_moves as twm
from graphaligner_tpu.graph import load_alignment_graph as jax_graph
from graphaligner_tpu.io import load_fastq
from graphaligner_tpu.runtime.aligner import load_seed_hits
from graphaligner_tpu_torch.graph import load_alignment_graph as torch_graph

SIM = pathlib.Path(__file__).parent / "fixtures" / "sim"
CONFIGS = {"b35": (35, 0), "b5B20": (5, 20)}
N_READS = 10  # of 20: the port's CPU scan, not the read count, sets the time


@pytest.fixture(scope="module")
def corpus():
    reads = load_fastq(str(SIM / "sim.fastq"))[:N_READS]
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    return (jax_graph(str(SIM / "bubbles.vg")),
            torch_graph(str(SIM / "bubbles.vg")), reads, seeds)


def _port(graph, reads, seeds, bw, ramp, window=None):
    aligner = tba.BandedBatchAligner(graph, bw, ramp, "cpu")
    if window is not None:
        aligner.LONG_WINDOW = window
    res = tba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    return res, aligner


def _jax(graph, reads, seeds, bw, ramp, window):
    aligner = jba.BandedBatchAligner(graph, bw, ramp)
    aligner.LONG_WINDOW = window
    res = jba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    assert aligner._long_mode
    return res


def _same(reads, a, b, what):
    for r in reads:
        x, y = a[r.seq_id], b[r.seq_id]
        assert x.alignment_failed == y.alignment_failed, (what, r.seq_id)
        if not x.alignment_failed:
            assert x.alignment.encode() == y.alignment.encode(), (what,
                                                                  r.seq_id)


_NORMAL: dict = {}


@pytest.mark.parametrize("window", [4, 2])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_long_mode_matches_jax_and_normal(corpus, config, window):
    jg, tg, reads, seeds = corpus
    bw, ramp = CONFIGS[config]
    if config not in _NORMAL:
        _NORMAL[config] = _port(tg, reads, seeds, bw, ramp)[0]
    fb0 = tba.host_fallback_count()
    tba.LONG_STATS.clear()
    port, aligner = _port(tg, reads, seeds, bw, ramp, window)
    assert aligner._long_mode and len(aligner._chunk_rounds) >= 3
    st = tba.LONG_STATS
    assert st["lanes"] > 0 and st["lane windows"] > st["lanes"]
    assert min(st[k] for k in ("scan rounds", "replay", "walk", "recompute",
                               "K2 windows")) > 0
    assert tba.host_fallback_count() == fb0
    _same(reads, port, _jax(jg, reads, seeds, bw, ramp, window),
          "port long vs JAX long")
    _same(reads, port, _NORMAL[config], "port long vs port normal")


def test_long_mode_ramp_rewinds_across_window_edges(corpus):
    """Error bursts across the window edges at slices 4 and 8 (bp 256 and
    512) at b5/B20: ramp rewinds fire across rounds whose columns were
    dropped, and the bytes still equal the normal mode's and the JAX
    package's long mode."""
    jg, tg, base, seeds = corpus
    rng = np.random.default_rng(41)
    reads = []
    for r in base:
        seq = list(r.sequence)
        for b0 in (226, 482):
            for p in rng.integers(b0, min(b0 + 60, len(seq)), 20):
                seq[p] = "ACGT"[rng.integers(4)]
        reads.append(r.__class__(**{**r.__dict__, "sequence": "".join(seq)}))
    normal, _ = _port(tg, reads, seeds, 5, 20)
    rw0 = tba.rewind_count()
    long_, aligner = _port(tg, reads, seeds, 5, 20, window=4)
    assert aligner._long_mode
    assert tba.rewind_count() > rw0  # the scenario fired in long mode
    _same(reads, long_, normal, "port long vs port normal")
    _same(reads, long_, _jax(jg, reads, seeds, 5, 20, 4),
          "port long vs JAX long")


def test_redispatched_rounds_equal_the_originals(corpus, monkeypatch):
    """Every round of a long-mode chunk run again from its stashed scan
    inputs gives every output of the original, bit for bit (the dropped
    ones are kept aside here before they go)."""
    from graphaligner_tpu_torch.core.batch_align import seed_extension_problems

    _, tg, reads, seeds = corpus
    kept: dict = {}
    drop = tba._Round.drop

    def keep_then_drop(self, *keys):
        for key in keys:
            if key in self.out:
                kept.setdefault(id(self), {})[key] = self.out[key].clone()
        drop(self, *keys)

    monkeypatch.setattr(tba._Round, "drop", keep_then_drop)
    aligner = tba.BandedBatchAligner(tg, 5, 20, "cpu")
    aligner.LONG_WINDOW = 2
    problems = []
    for r in reads:
        for p in seed_extension_problems(tg, r.sequence, seeds[r.seq_id][0]):
            if p is not None:
                problems.append(p)
    aligner._run(problems)
    rounds = aligner._chunk_rounds
    assert len(rounds) >= 4 and rounds[0].dropped
    for rnd in rounds:
        again = aligner._redispatch_round(rnd)
        orig = {**rnd.out, **kept.get(id(rnd), {})}
        assert set(orig) == set(again)
        for key, want in orig.items():
            assert torch.equal(again[key], want), key
        last = again["cols"][torch.as_tensor(rnd.last_steps), :, :,
                             torch.as_tensor(rnd.last_lanes)]
        assert torch.equal(last, rnd.cols_last)


# bucket edges of the scan-length ladder {32, 96, 160, 320, 640}: reads of
# 33-48 slices run long at LONG_WINDOW 48, 161-320 at the Cm=1152 tier's
# window of 160, 321 on at 320
EDGES = [(32, 33), (48, 49), (96, 97), (160, 161), (176, 177), (320, 321)]
GATES = {"window48": (48, None), "window320": (320, None),
         "cm1152": (320, 1152)}


@pytest.fixture(scope="module")
def gate_aligners(corpus):
    jg, tg, _, _ = corpus
    out = {}
    for name, (window, Cm) in GATES.items():
        j = jba.BandedBatchAligner(jg, 35, 0, Cm=Cm)
        t = tba.BandedBatchAligner(tg, 35, 0, "cpu", Cm=Cm)
        j.LONG_WINDOW = t.LONG_WINDOW = window
        out[name] = (j, t)
    return out


@pytest.mark.parametrize("edge", EDGES, ids=lambda e: f"{e[0]}-{e[1]}")
@pytest.mark.parametrize("gate", list(GATES))
def test_long_mode_gate_matches_jax(gate_aligners, monkeypatch, gate, edge):
    """The port's choice of round length, long mode and round cap equals
    what the JAX package's _start_run chooses on both sides of each edge
    (its round dispatch stubbed out: only the choice is compared)."""
    j, t = gate_aligners[gate]
    monkeypatch.setattr(j, "_dispatch_round", lambda *a: None)
    for true_S in edge:
        problems = [("A" * 64 * true_S, 0), ("C" * 64 * 3, 1)]
        _, _, _, _, S_max, _, _, rounds_cap = j._start_run(problems)
        assert t._plan(problems) == (S_max, j._long_mode, rounds_cap,
                                     true_S), (gate, true_S)


def test_long_window_stays_off_the_retry_tier(corpus):
    """An instance's LONG_WINDOW does not reach its 2x tier in either
    package: the tier reads the class attribute."""
    jg, tg, _, _ = corpus
    j = jba.BandedBatchAligner(jg, 35, 0)
    t = tba.BandedBatchAligner(tg, 35, 0, "cpu")
    j.LONG_WINDOW = t.LONG_WINDOW = 4
    assert (j._next_tier().LONG_WINDOW == t._next_tier().LONG_WINDOW
            == tba.BandedBatchAligner.LONG_WINDOW)


def test_window_limits_equal_jax():
    for Cm in (288, 448, 576, 896, 1152, 1792, 2304):
        for Nm in (16, 32):
            assert twm.max_window_slices(Cm, Nm) == jwm.max_window_slices(
                Cm, Nm)
            assert twm.moves_walk_fits(Cm, Nm) == jwm.moves_walk_fits(Cm, Nm)


def test_top_tier_long_mode_fails_its_lanes(corpus):
    """At Cm = 2304 no window fits the TPU kernel, so long mode fails every
    lane in both packages (the ladder's top: no retry tier follows)."""
    jg, tg, reads, seeds = corpus
    from graphaligner_tpu_torch.core.batch_align import seed_extension_problems

    problems = [p for p in seed_extension_problems(
        tg, reads[0].sequence, seeds[reads[0].seq_id][0]) if p is not None]
    j = jba.BandedBatchAligner(jg, 35, 0, Cm=2304)
    t = tba.BandedBatchAligner(tg, 35, 0, "cpu", Cm=2304)
    j.LONG_WINDOW = t.LONG_WINDOW = 4
    got, want = t.get_traces(problems), j.get_traces(problems)
    assert t._long_mode and j._long_mode
    assert None in got and got == want
