"""The port's exhaustive-mode engine (-i) against graphaligner_tpu's.

Each package loads the graph and reads itself; the port runs K3's plain
version on the CPU, the JAX package its own engine. Alignments are held
equal as ``encode()`` bytes and scores (the two packages have their own
message classes), the host finalisation's minima and minimum indices as
values. The committed -i goldens are re-derived through the JAX package.
"""

import importlib.util
import pathlib
import random

import numpy as np
import pytest

from graphaligner_tpu.core import engine as jeng
from graphaligner_tpu.graph import graph_from_gfa_file, load_alignment_graph
from graphaligner_tpu.io import load_fastq
from graphaligner_tpu.io.fastq import FastQ
from graphaligner_tpu_torch.core import engine as teng
from graphaligner_tpu_torch.graph import (
    graph_from_gfa_file as t_graph_from_gfa_file,
    load_alignment_graph as t_load_alignment_graph,
)
from graphaligner_tpu_torch.io import load_fastq as t_load_fastq

FIX = pathlib.Path(__file__).parent / "fixtures"
SIM = FIX / "sim"


def _sim6():
    reads = load_fastq(str(SIM / "sim.fastq"))[:6]
    return str(SIM / "bubbles.vg"), reads


def _mixed():
    # a short read beside a full one: each must align as if alone
    # (test_engine.py::test_engine_mixed_lengths)
    reads = load_fastq(str(SIM / "sim.fastq"))
    short = FastQ(seq_id="short", sequence=reads[0].sequence[:100],
                  quality="!" * 100)
    return str(SIM / "bubbles.vg"), [short, reads[1]]


def _cyclic():
    # reads that walk the repeat cycle twice, mutated at 5%
    # (test_engine.py::test_engine_cyclic_matches_oracle)
    seqs = {}
    for line in open(SIM / "cyclic.gfa"):
        if line.startswith("S\t"):
            _, nid, seq = line.split()
            seqs[int(nid)] = seq
    rng = random.Random(11)
    path = [6, 7, 8, 9, 10, 11, 12, 8, 9, 10, 11, 12, 13, 14]
    truth = "".join(seqs[n] for n in path)
    reads = []
    for i in range(3):
        mut = "".join(
            rng.choice("ACGT") if rng.random() < 0.05 else c for c in truth
        )
        reads.append(FastQ(seq_id=f"cyc{i}", sequence=mut, quality="!" * len(mut)))
    return str(SIM / "cyclic.gfa"), reads


CASES = {"sim6": _sim6, "mixed": _mixed, "cyclic": _cyclic}


def _graphs(path):
    if path.endswith(".gfa"):
        return graph_from_gfa_file(path), t_graph_from_gfa_file(path)
    return load_alignment_graph(path), t_load_alignment_graph(path)


def _encoded(results):
    return [(r.alignment.score, r.alignment.encode()) for r in results]


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_band_matches_jax(case):
    path, reads = CASES[case]()
    jgraph, tgraph = _graphs(path)
    want = _encoded(jeng.align_batch_full_band(jgraph, reads))
    got = _encoded(teng.align_batch_full_band(tgraph, reads, device="cpu"))
    assert got == want
    assert any(score > 0 for score, _ in got)


def test_vectorised_minima_match_jax_views():
    """node_min, the slice minima, their index lists and the HMM states of
    the port's vectorised finalisation equal the JAX package's per-node
    loops on the same slabs."""
    path, reads = _sim6()
    jgraph, tgraph = _graphs(path)
    ba = teng.BatchAligner(tgraph, "cpu")
    seqs = [r.sequence for r in reads[:4]]
    seqs[1] = seqs[1][:150]  # a read of fewer slices than the batch
    views = ba.compute_tables(seqs)
    jsched = jeng.build_schedule(jgraph)
    for read_views in views:
        jviews = []
        for v in read_views:
            s, b = v._sb
            vp_lo, vp_hi, vn_lo, vn_hi, sbs, send = (x[s, :, b] for x in v._slabs)
            jviews.append(jeng.DeviceSliceView(
                jsched, v.j, vp_lo, vp_hi, vn_lo, vn_hi,
                sbs.astype(np.int64), send.astype(np.int64),
            ))
            want = jviews[-1].node_min
            assert {n: int(v.node_min[n]) for n in want} == want
        jtable = jeng._finalize_table(jgraph, jviews)
        ttable = teng._finalize_table(ba, read_views)
        assert len(ttable.slices) == len(jtable.slices)
        for tv, jv in zip(ttable.slices[1:], jtable.slices[1:]):
            assert tv.min_score == jv.min_score
            assert tv.min_score_index == jv.min_score_index
            assert (tv.correctness.currently_correct(),
                    tv.correctness.false_from_correct()) == (
                jv.correctness.currently_correct(),
                jv.correctness.false_from_correct())


def test_schedule_matches_jax():
    for path in (str(SIM / "bubbles.vg"), str(SIM / "cyclic.gfa")):
        jgraph, tgraph = _graphs(path)
        want = jeng.build_schedule(jgraph)
        got = teng.build_schedule(tgraph)
        for name in ("cell_pos", "code", "is_start", "is_source_start",
                     "pred_nodes", "node_slot", "pos_to_step"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
        assert (got.num_nodes, got.cyclic) == (want.num_nodes, want.cyclic)


def test_lanes_that_fit_follow_free_memory(monkeypatch):
    """The -i chunk is what half the free memory holds: 24 * S * P bytes
    of slabs a lane and the smaller per-lane terms (the wavefront's node
    store once per slice-warp), capped, at least 1."""
    ba = teng.BatchAligner(t_load_alignment_graph(str(SIM / "bubbles.vg")), "cpu")
    S, P, N = 11, len(ba.sched.code), ba.sched.num_nodes
    slabs = 24 * S * P
    assert not ba.sched.cyclic and S <= 16  # one store a slice-warp
    lane = (slabs + 8 * S * N + 104 * S) + (slabs + 24 * S * N + 40 * S) \
        + 2 * slabs + 48 * N
    for lanes in (1, 3, 40):
        monkeypatch.setattr(teng, "host_free_bytes", lambda n=lanes: 2 * lane * n)
        assert ba.lanes_that_fit(S, 4096) == lanes
        assert ba.lanes_that_fit(S, 2) == min(lanes, 2)
    monkeypatch.setattr(teng, "host_free_bytes", lambda: 0)
    assert ba.lanes_that_fit(S, 4096) == 1


def test_memory_cut_chunks_match_the_golden(monkeypatch, tmp_path):
    """With memory for two lanes, -i runs 6 sim reads in three chunks and
    still writes each read's golden alignment."""
    from graphaligner_tpu_torch.io import stream, vg
    from graphaligner_tpu_torch.runtime import aligner

    ba_cls = teng.BatchAligner
    chunks = []

    def two_lanes(self, num_slices, cap):
        chunks.append(num_slices)
        return min(cap, 2)

    monkeypatch.setattr(ba_cls, "lanes_that_fit", two_lanes)
    calls = []
    orig = teng.align_batch_full_band

    def rec(graph, reads, **kw):
        calls.append(len(reads))
        return orig(graph, reads, **kw)

    monkeypatch.setattr(teng, "align_batch_full_band", rec)
    graph = t_load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = t_load_fastq(str(SIM / "sim.fastq"))[:6]
    alns = aligner._align_reads_batched(graph, reads, lambda *a: None,
                                        str(tmp_path), 4096, "cpu")
    assert chunks == [max((len(r.sequence) + 63) // 64 for r in reads)]
    assert calls == [2, 2, 2]
    gold = {a.name: a.encode() for a in stream.read_messages(
        str(FIX / "torch" / "sim_i" / "out.gam"), vg.Alignment)}
    assert alns and len(alns) == sum(r.seq_id in gold for r in reads)
    for a in alns:
        assert a.encode() == gold[a.name]


def _make_goldens():
    spec = importlib.util.spec_from_file_location(
        "make_goldens", FIX / "torch" / "make_goldens.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["smallexample_i", "sim_i", "cyclic_i"])
def test_goldens_rederived_through_jax(name, tmp_path):
    """The committed -i goldens are what the JAX package writes today."""
    out = tmp_path / "out.gam"
    _make_goldens().make(name, str(out))
    assert out.read_bytes() == (FIX / "torch" / name / "out.gam").read_bytes()


def test_cyclic_i_matches_its_golden(tmp_path):
    """-i on the cyclic graph (the serial fixpoint route on the card, the
    plain version here) writes the JAX-made golden of every read."""
    from graphaligner_tpu_torch.core.params import AlignerParams
    from graphaligner_tpu_torch.io import stream, vg
    from graphaligner_tpu_torch.runtime.aligner import align_reads

    d = FIX / "torch" / "cyclic_i"
    params = AlignerParams(graph_file=str(SIM / "cyclic.gfa"),
                           fastq_file=str(d / "reads.fastq"),
                           initial_bandwidth=35, initial_full_band=True)
    alns = align_reads(params, log=lambda *a: None, output_dir=str(tmp_path),
                       backend="cpu")
    gold = {a.name: a.encode()
            for a in stream.read_messages(str(d / "out.gam"), vg.Alignment)}
    assert len(gold) == 32 and {a.name: a.encode() for a in alns} == gold


def test_port_reads_match_jax_reads():
    want = load_fastq(str(SIM / "sim.fastq"))
    got = t_load_fastq(str(SIM / "sim.fastq"))
    assert [(r.seq_id, r.sequence, r.quality) for r in got] == [
        (r.seq_id, r.sequence, r.quality) for r in want
    ]
