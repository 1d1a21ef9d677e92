"""The port's banded slice scan against graphaligner_tpu's banded_scan.

Same graph tables, reach table and seeded problems through both; the JAX
scan runs its production cell path (the Pallas cell kernel in interpret
mode, GA_FORCE_PALLAS=1) and the port runs K1's plain version on the CPU.
Every output array must be identical (tolerance zero: all integer), in
plain lanes and in segmented lanes (several problems back to back).
"""

import pathlib

import numpy as np
import pytest
import torch

from graphaligner_tpu.core.align import _pad_to_word
from graphaligner_tpu.core.engine import _READ_CODE, encode_read
from graphaligner_tpu.core.engine_banded import (
    banded_scan as jax_banded_scan,
    build_graph_tables,
    make_seed_carry,
)
from graphaligner_tpu.core.params import WORD_SIZE
from graphaligner_tpu.core.reach import ensure_reach
from graphaligner_tpu.graph import load_alignment_graph
from graphaligner_tpu.graph.bigraph import graph_from_gfa_file
from graphaligner_tpu.io import load_fastq
from graphaligner_tpu.runtime.aligner import load_seed_hits
from graphaligner_tpu_torch.core.engine_banded import banded_scan
from graphaligner_tpu_torch.core.tables import band_hash_np, device_tables

FIX = pathlib.Path(__file__).parent / "fixtures"
SIM = FIX / "sim"
BW = 35


def _sim():
    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    return graph, reads, seeds


def _gwws():
    graph = load_alignment_graph(str(FIX / "gwws_fail_ex1.vg"))
    reads = load_fastq(str(FIX / "gwws" / "sim.fastq"))
    seeds = load_seed_hits(
        str(FIX / "gwws" / "seeds.gam"), [r.seq_id for r in reads]
    )
    return graph, reads, seeds


def _cyclic():
    """Reads that walk the repeat cycle of cyclic.gfa twice (as
    test_banded_cyclic.py builds them), so bands carry back edges."""
    import random

    graph = graph_from_gfa_file(str(SIM / "cyclic.gfa"))
    seqs = {}
    for line in open(SIM / "cyclic.gfa"):
        if line.startswith("S\t"):
            _, nid, seq = line.split()
            seqs[int(nid)] = seq
    rng = random.Random(7)
    path = [6, 7, 8, 9, 10, 11, 12, 8, 9, 10, 11, 12, 13, 14]
    truth = "".join(seqs[n] for n in path)
    from graphaligner_tpu.io.fastq import FastQ

    reads, seeds = [], {}
    for i in range(4):
        read = "".join(
            c if rng.random() > 0.05 else rng.choice("ACGT") for c in truth
        )
        reads.append(FastQ(seq_id=f"cyc{i}", sequence=read, quality="!"))
        seeds[f"cyc{i}"] = [(path[0], 0, False)]
    return graph, reads, seeds


def _cyclic_indels():
    """The reads of test_banded_cyclic.py: six walks around the repeat,
    mutated with substitutions and indels (random seed 7)."""
    import random

    from graphaligner_tpu.io.fastq import FastQ

    graph = graph_from_gfa_file(str(SIM / "cyclic.gfa"))
    seqs = {}
    for line in open(SIM / "cyclic.gfa"):
        if line.startswith("S\t"):
            _, nid, seq = line.split()
            seqs[int(nid)] = seq
    rng = random.Random(7)
    path = [6, 7, 8, 9, 10, 11, 12, 8, 9, 10, 11, 12, 13, 14]
    truth = "".join(seqs[n] for n in path)
    reads, seeds = [], {}
    for i in range(6):
        out = []
        for c in truth:
            r = rng.random()
            if r < 0.05 / 3:
                continue
            if r < 2 * 0.05 / 3:
                out.append(rng.choice("ACGT"))
                continue
            out.append(c)
            if rng.random() < 0.05 / 3:
                out.append(rng.choice("ACGT"))
        read = "".join(out)
        reads.append(FastQ(seq_id=f"cyc{i}", sequence=read, quality="!"))
        seeds[f"cyc{i}"] = [(path[0], 0, False)]
    return graph, reads, seeds


CORPORA = {"sim": _sim, "gwws": _gwws, "cyclic": _cyclic,
           "cyclic_indels": _cyclic_indels}


def _problems(graph, reads, seeds, n):
    out = []
    for r in reads[:n]:
        node_id, pos, reverse = seeds[r.seq_id][0]
        fw = graph.node_lookup[node_id * 2 + (1 if reverse else 0)]
        out.append((_pad_to_word(r.sequence[pos:]), fw))
    return out


def _plain_inputs(tables, problems, Nm, Cm):
    B = len(problems)
    S_max = max(len(p[0]) // WORD_SIZE for p in problems)
    codes = np.full((B, S_max * WORD_SIZE), _READ_CODE["N"], dtype=np.uint8)
    seq_len = np.zeros(B, np.int32)
    steps = np.zeros(B, np.int32)
    starts = np.zeros(B, np.int32)
    for i, (seq, node) in enumerate(problems):
        codes[i, : len(seq)] = encode_read(seq)
        seq_len[i] = len(seq)
        steps[i] = len(seq) // WORD_SIZE
        starts[i] = node
    carry = make_seed_carry(tables, starts, Nm, Cm)
    args = (codes, seq_len, steps, np.zeros(B, np.int32),
            np.full((S_max, B), BW, np.int32), *carry)
    return args, S_max, None


def _segmented_inputs(tables, problems, Nm, Cm):
    """Two problems per lane, back to back, as batch_align packs them."""
    B = (len(problems) + 1) // 2
    sizes = [len(p[0]) // WORD_SIZE for p in problems]
    S_max = max(sizes[2 * l] + (sizes[2 * l + 1] if 2 * l + 1 < len(sizes)
                                else 0) for l in range(B))
    codes = np.full((B, S_max * WORD_SIZE), _READ_CODE["N"], dtype=np.uint8)
    seg = [np.zeros((S_max, B), np.int32) for _ in range(3)]
    seg.append(np.full((S_max, B), -1, np.int32))
    seg.append(np.zeros((S_max, B), np.int32))
    bw = np.full((S_max, B), BW, np.int32)
    bw[::3] = BW + 10  # a ramped schedule on some steps
    for i, (seq, node) in enumerate(problems):
        l, s0 = i // 2, (sizes[i - 1] if i % 2 else 0)
        n = sizes[i]
        codes[l, s0 * WORD_SIZE:(s0 + n) * WORD_SIZE] = encode_read(seq)
        seg[0][s0:s0 + n, l] = 1
        seg[1][s0, l] = 1
        seg[2][s0:s0 + n, l] = len(seq)
        seg[3][s0, l] = node
        seg[4][s0, l] = int(tables.node_len[node])
    z = np.zeros(B, np.int32)
    init = (
        np.full((B, Nm), 2**31 - 1, np.int32),
        np.full((B, Cm), 1 << 20, np.int32),
        np.full((B, Nm), 1 << 20, np.int32),
        np.full((B, Nm), 1 << 20, np.int32),
        z,
    )
    args = (codes, z, z, z, bw, *init)
    return args, S_max, tuple(seg)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("mode", ["plain", "segmented"])
def test_banded_scan_matches_jax(corpus, mode, monkeypatch):
    import graphaligner_tpu_torch.ops.banded_cell as k1

    monkeypatch.setenv("GA_FORCE_PALLAS", "1")
    passes = []  # cell passes of each slice
    orig_slice, orig_cell = k1.slice_cells_plain, k1.banded_cell_plain

    def count_slice(*a, **kw):
        passes.append(0)
        return orig_slice(*a, **kw)

    def count_cell(*a, **kw):
        passes[-1] += 1
        return orig_cell(*a, **kw)

    monkeypatch.setattr(k1, "slice_cells_plain", count_slice)
    monkeypatch.setattr(k1, "banded_cell_plain", count_cell)
    graph, reads, seeds = CORPORA[corpus]()
    tables = build_graph_tables(graph)
    reach = ensure_reach(tables, BW + 10 + WORD_SIZE - 1)
    assert reach is not None
    Nm, Cm = 32, 192
    problems = _problems(graph, reads, seeds, 4)
    make = _plain_inputs if mode == "plain" else _segmented_inputs
    args, S_max, seg = make(tables, problems, Nm, Cm)
    ref = jax_banded_scan(
        *tables.device_args(), *args, S_max=S_max, Nm=Nm, Cm=Cm,
        _proj="reach", reach=reach, seg=seg, tie8=(mode == "segmented"),
    )
    dt = device_tables(tables, reach, "cpu")
    got = banded_scan(dt, *args, S_max=S_max, Nm=Nm, Cm=Cm, seg=seg,
                      tie8=(mode == "segmented"))
    assert set(got) == set(ref)
    for key in sorted(ref):
        want = np.asarray(ref[key])
        have = got[key].numpy()
        assert have.dtype == want.dtype, key
        np.testing.assert_array_equal(have, want, err_msg=key)
    # the host mirror of the band-row hash (the native tie replay's check)
    np.testing.assert_array_equal(
        got["ids_sub"].numpy(),
        band_hash_np(np.moveaxis(got["band_ids"].numpy()[::8], 1, -1)),
    )
    assert len(passes) == S_max and min(passes) >= 1
    if corpus.startswith("cyclic"):
        # the fixpoint must have had back edges to repeat over: some lane
        # took more than one pass
        assert (np.asarray(ref["num_cells"]) > 0).any()
        assert max(passes) > 1

