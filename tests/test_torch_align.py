"""The port's per-read host path on the CPU, with zero tolerance.

- ``core.align.align_one_way_seeded`` and ``align_one_way_full_band``
  against the JAX package's on smallexample, sim (-b 35, -b 5 -B 20 and
  reverse seeds), the small multi-allelic corpus (in-degree 8), the small
  converging corpus (in-degree 80) and, full band, smallexample and
  sim/bubbles.vg: the same alignment bytes, trace items and positions.
- ``merge_alignments`` and ``_add_alignment_nodes`` against the JAX
  package's on every piecewise trace of those runs.
- The CLI with ``--backend oracle`` writes the reference binary's goldens
  byte for byte: smallexample (GAM and trace), sim at both configs and
  reversed (a subset of reads, with their per-read GAM and trace files),
  and gwws at both configs (every read).

The scalar oracle is pure Python (about 0.25 s a sim read, 1.2 s a
multi-allelic one), so the JAX comparisons run on subsets.
"""

import functools
import pathlib

import pytest

from graphaligner_tpu.core import align as jax_align
from graphaligner_tpu.graph import load_alignment_graph as jax_graph
from graphaligner_tpu.io import load_fastq, stream, vg
from graphaligner_tpu.runtime.aligner import load_seed_hits
from graphaligner_tpu_torch.core import align as port_align
from graphaligner_tpu_torch.graph import load_alignment_graph as port_graph

FIX = pathlib.Path(__file__).parent / "fixtures"
SIM = FIX / "sim"
SMALL = FIX / "smallexample"
TORCH = FIX / "torch"

# name -> (graph, reads, seeds or None for full band, -b, -B, read ids)
CASES = {
    "smallexample": (SMALL / "sub_test.vg", SMALL / "read.fastq",
                     SMALL / "seedalignment.gam", 35, 0, None),
    "sim_b35": (SIM / "bubbles.vg", SIM / "sim.fastq", SIM / "seeds.gam",
                35, 0, slice(0, 2)),
    "sim_b5_B20": (SIM / "bubbles.vg", SIM / "sim.fastq", SIM / "seeds.gam",
                   5, 20, slice(2, 4)),
    "sim_rev": (SIM / "bubbles.vg", SIM / "reads_rc.fastq",
                SIM / "seeds_rc.gam", 35, 0, slice(4, 6)),
    "multiallelic_small": (TORCH / "multiallelic_small" / "graph.gfa",
                           TORCH / "multiallelic_small" / "reads.fastq",
                           TORCH / "multiallelic_small" / "seeds.gam",
                           35, 0, slice(1, 2)),
    "converging_small": (TORCH / "converging_small" / "graph.gfa",
                         TORCH / "converging_small" / "reads.fastq",
                         TORCH / "converging_small" / "seeds.gam",
                         35, 0, slice(0, 3)),
    "smallexample_i": (SMALL / "sub_test.vg", SMALL / "read.fastq", None,
                       35, 0, None),
    "sim_i": (SIM / "bubbles.vg", SIM / "sim.fastq", None, 35, 0,
              slice(18, 20)),
}


@functools.lru_cache(maxsize=None)
def _graphs(path):
    return jax_graph(str(path)), port_graph(str(path))


def _trace_rows(trace):
    return [(t.node_id, t.offset, t.reverse, t.readpos, int(t.type),
             t.graph_char, t.read_char) for t in trace]


def _summary(res):
    out = {"failed": res.alignment_failed, "cells": res.cells_processed,
           "trace": _trace_rows(res.trace)}
    if not res.alignment_failed:
        out.update(aln=res.alignment.encode(), start=res.alignment_start,
                   end=res.alignment_end)
    return out


@pytest.fixture(scope="module")
def runs():
    """Each case run through both packages once; the port's piecewise
    traces recorded where its _add_alignment_nodes takes them."""
    done = {}

    def run(name):
        if name in done:
            return done[name]
        graph_file, reads_file, seeds_file, bw, ramp, subset = CASES[name]
        jg, pg = _graphs(graph_file)
        reads = load_fastq(str(reads_file))
        reads = reads[subset] if subset else reads
        traces = []  # (read, piecewise trace)
        current = []
        orig = port_align._add_alignment_nodes

        def record(graph, tried, trace):
            traces.append((current[-1], trace))
            return orig(graph, tried, trace)

        port_align._add_alignment_nodes = record
        pairs = []
        try:
            if seeds_file is None:
                for r in reads:
                    pairs.append((
                        jax_align.align_one_way_full_band(
                            jg, r.seq_id, r.sequence, bw, ramp),
                        port_align.align_one_way_full_band(
                            pg, r.seq_id, r.sequence, bw, ramp)))
            else:
                seeds = load_seed_hits(str(seeds_file),
                                       [r.seq_id for r in reads])
                for r in reads:
                    current.append(r)
                    pairs.append((
                        jax_align.align_one_way_seeded(
                            jg, r.seq_id, r.sequence, bw, ramp,
                            seeds[r.seq_id]),
                        port_align.align_one_way_seeded(
                            pg, r.seq_id, r.sequence, bw, ramp,
                            seeds[r.seq_id])))
        finally:
            port_align._add_alignment_nodes = orig
        done[name] = (reads, pairs, traces)
        return done[name]

    return run


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_one_way_matches_jax(case, runs):
    reads, pairs, traces = runs(case)
    assert len(pairs) == len(reads)
    for want, got in pairs:
        assert _summary(got) == _summary(want)
    if CASES[case][2] is None:
        assert not traces  # full band has no seeds to record
    else:
        assert len(traces) >= len(reads)
    assert any(not got.alignment_failed for _, got in pairs)


@pytest.mark.parametrize("case", sorted(c for c in CASES if CASES[c][2]))
def test_merge_and_alignment_nodes_match_jax(case, runs):
    """On each piecewise trace of the run: the nodes a trace records for
    skipping later seeds, and the merged backward + forward alignment."""
    _, _, traces = runs(case)
    jg, pg = _graphs(CASES[case][0])
    merged = 0
    for r, trace in traces:
        tried_jax, tried_port = [], []
        jax_align._add_alignment_nodes(jg, tried_jax, trace)
        port_align._add_alignment_nodes(pg, tried_port, trace)
        assert tried_port == tried_jax
        (fw_score, fw), (bw_score, bw) = trace
        if not fw and not bw:
            continue
        pieces = []
        for mod, g in ((jax_align, jg), (port_align, pg)):
            fwres = mod.trace_to_alignment(g, r.seq_id, r.sequence, fw_score,
                                           fw, 0)
            bwres = mod.trace_to_alignment(g, r.seq_id, r.sequence, bw_score,
                                           bw, 0)
            if fwres.alignment_failed and bwres.alignment_failed:
                pieces.append(None)
                continue
            m = mod.merge_alignments(g, bwres, fwres)
            pieces.append((m.alignment.encode(), m.alignment_failed,
                           m.cells_processed, m.elapsed_milliseconds))
        assert pieces[1] == pieces[0]
        merged += pieces[0] is not None
    assert merged


def _reads_subset(reads_file, subset, tmp_path):
    reads = load_fastq(str(reads_file))
    if subset is None:
        return reads_file, reads
    reads = reads[subset]
    out = tmp_path / "reads.fastq"
    out.write_text("".join(f"@{r.seq_id}\n{r.sequence}\n+\n{r.quality}\n"
                           for r in reads))
    return out, reads


# name -> (graph, reads, seeds, -b, -B, golden GAM, read ids); the golden
# GAM's directory holds the per-read files where they were kept
GOLDENS = {
    "smallexample": (SMALL / "sub_test.vg", SMALL / "read.fastq",
                     SMALL / "seedalignment.gam", 35, 0,
                     FIX / "golden" / "seeded.gam", None),
    "sim_b35": (SIM / "bubbles.vg", SIM / "sim.fastq", SIM / "seeds.gam",
                35, 0, SIM / "golden_b35" / "out.gam", slice(16, 20)),
    "sim_b5_B20": (SIM / "bubbles.vg", SIM / "sim.fastq", SIM / "seeds.gam",
                   5, 20, SIM / "golden_b5_B20" / "out.gam", slice(8, 12)),
    "sim_b35_rev": (SIM / "bubbles.vg", SIM / "reads_rc.fastq",
                    SIM / "seeds_rc.gam", 35, 0,
                    SIM / "golden_b35_rev" / "out.gam", slice(12, 16)),
    "gwws_b35": (FIX / "gwws_fail_ex1.vg", FIX / "gwws" / "sim.fastq",
                 FIX / "gwws" / "seeds.gam", 35, 0,
                 FIX / "gwws" / "golden_b35" / "out.gam", None),
    "gwws_b5_B20": (FIX / "gwws_fail_ex1.vg", FIX / "gwws" / "sim.fastq",
                    FIX / "gwws" / "seeds.gam", 5, 20,
                    FIX / "gwws" / "golden_b5_B20" / "out.gam", None),
}


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_cli_oracle_writes_reference_goldens(case, tmp_path, monkeypatch):
    from graphaligner_tpu_torch.runtime import cli

    graph, reads_file, seeds, bw, ramp, gam, subset = GOLDENS[case]
    reads_file, reads = _reads_subset(reads_file, subset, tmp_path)
    monkeypatch.chdir(tmp_path)
    argv = ["-g", str(graph), "-f", str(reads_file), "-s", str(seeds),
            "-b", str(bw), "-a", "out.gam", "--backend", "oracle"]
    assert cli.main(argv + (["-B", str(ramp)] if ramp else [])) == 0
    if subset is None:
        assert (tmp_path / "out.gam").read_bytes() == gam.read_bytes()
    names = {r.seq_id for r in reads}
    want = [a.encode() for a in stream.read_messages(str(gam), vg.Alignment)
            if a.name in names]
    got = stream.read_messages(str(tmp_path / "out.gam"), vg.Alignment)
    assert [a.encode() for a in got] == want
    assert len(want) == len(reads)
    # the per-read files, wherever the golden directory holds them (gwws's
    # holds none: ROADMAP section 3)
    checked = 0
    for r in reads:
        for name in (f"alignment_0_{r.seq_id}.gam",
                     f"trace_0_{r.seq_id}.trace"):
            if (gam.parent / name).exists():
                assert (tmp_path / name).read_bytes() == \
                    (gam.parent / name).read_bytes(), name
                checked += 1
    if not case.startswith("gwws"):
        assert checked >= len(reads)
