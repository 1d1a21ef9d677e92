"""The port's batched seeded traces against the JAX package's, problem by
problem: ``BandedBatchAligner.get_traces`` gives (score, trace, table
slices, cells) or None for each extension problem, and the two packages'
must be equal, on sim (its first 8 reads) and on the reference's crash
graph gwws_fail_ex1 (its 12 reads). At -b 5 -B 20 the literal control
replay takes lanes and rewinds them; at -b 35 the vectorized replay
finishes every lane and each walked table is one straight run.
"""

import pathlib

import numpy as np
import pytest

import graphaligner_tpu.core.batch_align as jba
import graphaligner_tpu_torch.core.batch_align as tba
from graphaligner_tpu.graph import load_alignment_graph as jax_graph
from graphaligner_tpu.io import load_fastq
from graphaligner_tpu.runtime.aligner import load_seed_hits
from graphaligner_tpu_torch.graph import load_alignment_graph as torch_graph
from graphaligner_tpu_torch.utils import trace

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
CORPORA = {
    "sim": (FIXTURES / "sim" / "bubbles.vg", FIXTURES / "sim", 8),
    "gwws": (FIXTURES / "gwws_fail_ex1.vg", FIXTURES / "gwws", None),
}


@pytest.fixture(scope="module")
def corpora():
    out = {}
    for name, (graph, folder, n) in CORPORA.items():
        reads = load_fastq(str(folder / "sim.fastq"))[:n]
        seeds = load_seed_hits(str(folder / "seeds.gam"),
                               [r.seq_id for r in reads])
        jg, tg = jax_graph(str(graph)), torch_graph(str(graph))
        problems = [
            p
            for r in reads
            for seed in seeds.get(r.seq_id, [])
            for p in tba.seed_extension_problems(tg, r.sequence, seed)
            if p is not None
        ]
        assert problems == [
            p
            for r in reads
            for seed in seeds.get(r.seq_id, [])
            for p in jba.seed_extension_problems(jg, r.sequence, seed)
            if p is not None
        ]
        out[name] = (jg, tg, problems)
    return out


def _plain(results):
    return [None if r is None
            else (int(r[0]), np.asarray(r[1], np.int64).reshape(-1, 2).tolist(),
                  int(r[2]), int(r[3]))
            for r in results]


@pytest.mark.parametrize("config", [(35, 0), (5, 20)], ids=["b35", "b5B20"])
def test_get_traces_match_jax(corpora, config):
    bw, ramp = config
    counters = {}
    for name, (jg, tg, problems) in corpora.items():
        trace.enable()
        trace.reset()
        try:
            port = tba.BandedBatchAligner(tg, bw, ramp, "cpu").get_traces(
                problems)
            c = trace.snapshot()["counters"]
        finally:
            trace.disable()
            trace.reset()
        want = jba.BandedBatchAligner(jg, bw, ramp).get_traces(problems)
        assert _plain(port) == _plain(want), name
        counters[name] = c
        if config == (35, 0) and name == "sim":
            walked = sum(r is not None and r[2] > 0 for r in port)
            assert walked > 0
            assert c["walk.accepted_runs"] == walked
    if config == (5, 20):
        # the literal replay took lanes, and rewound (truncated) chains
        assert sum(c["scan.rewinds"] for c in counters.values()) > 0
        assert sum(c["scan.literal_lanes"] for c in counters.values()) > 0
