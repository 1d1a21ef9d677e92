"""The port's tracer (``graphaligner_tpu_torch/utils/trace.py``) on the CPU.

- Off, ``span`` is one shared no-op and a seeded batch records nothing.
- On, on sim at -b 35: every span lies inside its parent, every name is
  documented, the root ``align`` holds the call's spans; the scan's slice
  and lane-slice counters equal counts taken from the chunks' problems,
  and the band-node counters equal counts taken from the rounds'
  ``band_ids`` and active masks; the GAM bytes equal those of a run with
  tracing off.
- The vectorized replay's lanes and those handed to the literal replay
  account for every lane of the chunks.
- Long-read mode (a forced window of 4 slices) walks more lane-windows
  than lanes, and its spans nest as the normal mode's.
- ``seconds`` takes the union of nested spans.
"""

import pathlib

import numpy as np
import pytest
import torch

from graphaligner_tpu_torch.core import batch_align as ba
from graphaligner_tpu_torch.core.params import WORD_SIZE
from graphaligner_tpu_torch.core.tables import EMPTY
from graphaligner_tpu_torch.graph.bigraph import load_alignment_graph
from graphaligner_tpu_torch.io import load_fastq
from graphaligner_tpu_torch.runtime.aligner import (
    _finalize_output_alignment,
    load_seed_hits,
)
from graphaligner_tpu_torch.utils import trace

SIM = pathlib.Path(__file__).parent / "fixtures" / "sim"
N_READS = 12


@pytest.fixture(scope="module")
def corpus():
    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))[:N_READS]
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    return graph, reads, seeds


def _align(corpus, bw, ramp, window=None, rounds=None):
    """{read: GAM bytes} of one aligner's seeded batch and its finalize;
    with ``rounds`` a list, each scan round's (seg_active, LaneShards),
    each chunk's problems and lanes, and each lane the literal replay is
    handed are appended to it."""
    graph, reads, seeds = corpus
    aligner = ba.BandedBatchAligner(graph, bw, ramp, "cpu")
    if window is not None:
        aligner.LONG_WINDOW = window
    if rounds is not None:
        scan, run, replay = aligner._scan, aligner._run, aligner._replay

        def rec_scan(*a):
            out = scan(*a)
            rounds.append(("round", a[7][0], out))
            return out

        def rec_run(problems):
            rounds.append(("chunk", problems))
            lanes = run(problems)
            rounds.append(("lanes", lanes))
            return lanes

        def rec_replay(lane):
            rounds.append(("replay", lane))
            return replay(lane)

        aligner._scan, aligner._run = rec_scan, rec_run
        aligner._replay = rec_replay
    res = ba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    return {sid: _finalize_output_alignment(r.alignment).encode()
            for sid, r in res.items() if not r.alignment_failed}


def _traced(fn):
    trace.enable()
    trace.reset()
    try:
        out = fn()
        return out, trace.snapshot()
    finally:
        trace.disable()
        trace.reset()


@pytest.fixture(scope="module")
def traced_b35(corpus):
    rounds: list = []
    gam, snap = _traced(lambda: _align(corpus, 35, 0, rounds=rounds))
    return gam, snap, rounds


def test_off_records_nothing(corpus):
    assert not trace.on()
    assert trace.span("scan.issue") is trace.span("walk.issue")
    trace.reset()
    _align(corpus, 35, 0)
    snap = trace.snapshot()
    assert snap["spans"] == []
    assert not set(snap["counters"]) - set(trace.ALWAYS_ON)


def test_spans_nest_and_are_documented(traced_b35):
    _, snap, _ = traced_b35
    spans = snap["spans"]
    assert spans and all(e is not None for *_, e in spans)
    assert {n for n, *_ in spans} <= set(trace.SPANS)
    assert set(snap["counters"]) <= set(trace.COUNTERS) | set(trace.ALWAYS_ON)
    for name, parent, s, e in spans:
        assert s <= e
        if parent >= 0:
            _, _, ps, pe = spans[parent]
            assert ps <= s and e <= pe, name
    roots = [i for i, (n, p, _, _) in enumerate(spans) if n == "align"]
    assert len(roots) == 1 and spans[roots[0]][1] == -1
    _, _, s0, e0 = spans[roots[0]]

    def root(i):
        while spans[i][1] >= 0:
            i = spans[i][1]
        return i

    inside = [i for i, (_, _, s, e) in enumerate(spans) if s0 <= s <= e0]
    assert {root(i) for i in inside} == {roots[0]}
    # what lies outside the call: the aligner's set-up before it, each
    # read's GAM encode after it
    outside = {spans[i][0] for i in range(len(spans)) if i not in inside}
    assert outside == {"setup.tables", "setup.reverse_pos", "setup.reach",
                       "setup.device_tables", "finalize.gam"}
    for name in ("scan.bulk_lanes", "scan.literal_lanes",
                 "walk.accepted_runs"):
        assert name in trace.COUNTERS and name in snap["counters"], name
    names = {n for n, *_ in spans}
    for name in ("scan.pack", "scan.carry", "scan.upload", "scan.issue",
                 "fetch", "scan.unpack", "scan.replay", "walk.tail",
                 "walk.gather", "walk.starts", "walk.consolidate",
                 "walk.issue", "walk.decode", "align.wave", "align.chunks",
                 "finalize.entry", "finalize.read"):
        assert name in names, name


def test_scan_counters_equal_the_chunks_problems(traced_b35):
    _, snap, rounds = traced_b35
    c = snap["counters"]
    chunks = [r[1] for r in rounds if r[0] == "chunk"]
    scans = [r for r in rounds if r[0] == "round"]
    # -b 35 takes no rewind: one round a chunk, each problem whole in it
    assert c["scan.rewinds"] == 0
    assert c["scan.chunks"] == c["scan.rounds"] == len(chunks) == len(scans)
    bucket = [max(32, -(-max(len(s) for s, _ in ch) // WORD_SIZE))
              for ch in chunks]
    s_max = [int(seg.shape[0]) for _, seg, _ in scans]
    assert all(s >= b for s, b in zip(s_max, bucket))
    assert c["scan.slices"] == sum(s_max)
    assert c["scan.lane_slices"] == sum(len(s) // WORD_SIZE
                                        for ch in chunks for s, _ in ch)
    assert c["scan.lane_slices_launched"] == sum(
        int(seg.shape[0]) * int(seg.shape[1]) for _, seg, _ in scans)
    assert c["finalize.reads"] == N_READS


def test_bulk_and_literal_lanes_account_for_every_lane(traced_b35):
    """Every lane of the chunks is finished by the vectorized replay or
    handed to the literal one (which fails it, or advances it a slice or
    more, or finds it has no slice)."""
    _, snap, rounds = traced_b35
    c = snap["counters"]
    lanes = [lane for kind, *rest in rounds if kind == "lanes"
             for lane in rest[0]]
    literal = {id(rest[0]) for kind, *rest in rounds if kind == "replay"}
    stepped = [lane for lane in lanes if lane.stepped]
    assert lanes and c["scan.bulk_lanes"] > 0
    assert c["scan.bulk_lanes"] + len(literal) == len(lanes)
    assert c["scan.literal_lanes"] == len(stepped)
    assert {id(lane) for lane in stepped} <= literal
    assert all(lane.failed or lane.num_slices == 0
               for lane in lanes if id(lane) in literal and not lane.stepped)


def test_band_node_counters_equal_the_rounds_bands(traced_b35):
    _, snap, rounds = traced_b35
    c = snap["counters"]
    total, most = 0, 0
    for kind, *rest in rounds:
        if kind != "round":
            continue
        seg_active, out = rest
        band = out["band_ids"].numpy()  # [S, Nm, B]
        nodes = (band != int(EMPTY)).sum(axis=1) * (seg_active == 1)
        total += int(nodes.sum())
        most = max(most, int(nodes.max()))
    assert total > 0
    assert c["scan.band_nodes"] == total
    assert c["scan.band_nodes_max"] == most <= 32


def test_gam_bytes_equal_with_tracing_on_and_off(corpus, traced_b35):
    gam, _, _ = traced_b35
    assert len(gam) == N_READS
    assert gam == _align(corpus, 35, 0)


def test_long_mode_counters_and_spans(corpus):
    graph, reads, seeds = corpus
    small = (graph, reads[:4], seeds)
    _, snap = _traced(lambda: _align(small, 5, 20, window=4))
    c = snap["counters"]
    assert c["long.lane_windows"] > c["long.lanes"] > 0
    assert c["long.recompute_s"] > 0 and c["long.k2_windows_s"] > 0
    spans = snap["spans"]
    names = {n for n, *_ in spans}
    assert {"walk.recompute", "walk.consolidate", "walk.starts",
            "walk.issue", "walk.decode"} <= names <= set(trace.SPANS)
    # the recompute scans again, inside its walk span
    assert trace.seconds(snap, "scan.issue", inside="walk.recompute") > 0
    for name, parent, s, e in spans:
        if parent >= 0:
            assert spans[parent][2] <= s and e <= spans[parent][3], name


def test_counters_accumulate_numbers_and_tensors():
    trace.reset()
    trace.count("scan.rounds")
    trace.count("scan.band_nodes", torch.tensor([3, 4]))
    trace.peak("scan.band_nodes_max", torch.tensor([[2, 9], [1, 0]]))
    assert trace.snapshot()["counters"] == {
        k: 0 for k in trace.ALWAYS_ON}  # off: nothing recorded

    def fn():
        trace.count("scan.rounds")
        trace.count("scan.rounds", np.int64(2))
        trace.count("scan.band_nodes", torch.tensor([3, 4]))
        trace.count("scan.band_nodes", torch.tensor([5]))
        trace.peak("scan.band_nodes_max", torch.tensor([[2, 9], [1, 0]]))
        trace.peak("scan.band_nodes_max", torch.tensor([7]))
        trace.peak("long.peak_walk_bytes", 10)
        trace.peak("long.peak_walk_bytes", 4)

    _, snap = _traced(fn)
    c = snap["counters"]
    assert (c["scan.rounds"], c["scan.band_nodes"], c["scan.band_nodes_max"],
            c["long.peak_walk_bytes"]) == (3, 12, 9, 10)


def test_seconds_is_the_union_of_nested_spans():
    snap = {"spans": [
        ("scan.issue", -1, 0, 4_000_000_000),
        ("fetch", 0, 1_000_000_000, 2_000_000_000),
        ("scan.unpack", -1, 3_000_000_000, 6_000_000_000),
        ("walk.issue", -1, 7_000_000_000, 8_000_000_000),
        ("scan.replay", -1, 9_000_000_000, None),
    ]}
    assert trace.seconds(snap, "scan.") == 6.0
    assert trace.seconds(snap, "scan.issue", "fetch") == 4.0
    assert trace.seconds(snap, "fetch", inside="scan.issue") == 1.0
    assert trace.seconds(snap, "walk.", "fetch") == 2.0
    assert trace.seconds(snap, "scan.replay") == 0.0
