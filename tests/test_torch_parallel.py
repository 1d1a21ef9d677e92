"""The port's device mesh against graphaligner_tpu's (8 virtual CPU
devices via tests/conftest.py on the JAX side, a mesh of CPU devices on
the port's).

- ``BandedBatchAligner(mesh=...)`` on sim at -b 35: 8 and 3 shards (33
  lanes a round: B rounded up to a multiple of 3), with reach tables and
  without (GA_REACH_MAXN=0, where each shard's projection stops on its
  own, so the mesh run is held against the JAX mesh run); the GAM bytes of
  every read equal the JAX mesh run's and the port's one-device run's.
- The small multi-allelic corpus (in-degree 8: K1's and K2's wide routes,
  whose walk budget is the whole walk group's) on 4 shards against its
  JAX golden and the port's one-device run.
- Long-read mode on 4 shards (a forced window of 4 slices) against the
  port's one-device long mode.
- ``shard_reads_aligner`` (K3, -i) and ``shard_banded_scan`` against the
  JAX package's, array for array.
Tolerance zero throughout: GAM bytes, or integer arrays bit for bit.
"""

import pathlib

import numpy as np
import pytest
import torch

FIX = pathlib.Path(__file__).parent / "fixtures"
SIM = FIX / "sim"
MA = FIX / "torch" / "multiallelic_small"


def _port_corpus(graph_file, reads_file, seeds_file):
    from graphaligner_tpu_torch.graph.bigraph import load_alignment_graph
    from graphaligner_tpu_torch.io import load_fastq
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits

    graph = load_alignment_graph(str(graph_file))
    reads = load_fastq(str(reads_file))
    seeds = load_seed_hits(str(seeds_file), [r.seq_id for r in reads])
    return graph, reads, seeds


def _cpu_mesh(n):
    from graphaligner_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[torch.device("cpu")] * n)


def _port_run(corpus, bw, ramp, mesh=None, window=None, record=None):
    """{read: encoded alignment or None} of the port's seeded batch; with
    ``record`` a list, the lanes of every scan round are appended to it."""
    from graphaligner_tpu_torch.core import batch_align as ba

    graph, reads, seeds = corpus
    if mesh is None:
        aligner = ba.BandedBatchAligner(graph, bw, ramp, "cpu")
    else:
        aligner = ba.BandedBatchAligner(graph, bw, ramp, mesh=mesh)
    if window is not None:
        aligner.LONG_WINDOW = window
    orig = ba.banded_scan_shards
    if record is not None:
        def rec(dts, codes, *a, **kw):
            record.append((len(dts), codes.shape[0]))
            return orig(dts, codes, *a, **kw)

        ba.banded_scan_shards = rec
    try:
        res = ba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    finally:
        ba.banded_scan_shards = orig
    return _encoded(res)


def _encoded(res):
    return {
        sid: None if r.alignment_failed else r.alignment.encode()
        for sid, r in res.items()
    }


def _jax_mesh_run(nd, bw, ramp):
    from graphaligner_tpu.core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
    )
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq
    from graphaligner_tpu.parallel import make_mesh
    from graphaligner_tpu.runtime.aligner import load_seed_hits

    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    aligner = BandedBatchAligner(graph, bw, ramp, mesh=make_mesh(nd))
    return _encoded(align_reads_seeded_batch(graph, aligner, reads, seeds))


@pytest.fixture(scope="module")
def sim_single():
    """The port's one-device run on sim at -b 35, with reach tables."""
    return _port_run(_sim(), 35, 0)


def _sim():
    return _port_corpus(SIM / "bubbles.vg", SIM / "sim.fastq",
                        SIM / "seeds.gam")


@pytest.mark.parametrize("nd,reach", [(8, True), (8, False), (3, True)])
def test_mesh_gam_bytes_equal_jax_mesh(nd, reach, sim_single, monkeypatch):
    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    if not reach:
        monkeypatch.setenv("GA_REACH_MAXN", "0")
    rounds = []
    got = _port_run(_sim(), 35, 0, mesh=_cpu_mesh(nd), record=rounds)
    assert rounds and all(n == nd and B % nd == 0 for n, B in rounds)
    if nd == 3:
        assert (3, 33) in rounds  # 32 lanes rounded up to 3 equal shards
    want = _jax_mesh_run(nd, 35, 0)
    assert set(got) == set(want)
    assert sum(v is not None for v in got.values()) == 20
    for sid in want:
        assert got[sid] == want[sid], sid
    if reach:
        assert got == sim_single


def test_multiallelic_small_on_a_mesh(monkeypatch):
    """In-degree 8 at -b 5 -B 20 on 4 shards: the JAX golden and the
    port's one-device run, byte for byte."""
    from graphaligner_tpu_torch.io import stream, vg

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    corpus = _port_corpus(MA / "graph.gfa", MA / "reads.fastq",
                          MA / "seeds.gam")
    got = _port_run(corpus, 5, 20, mesh=_cpu_mesh(4))
    assert got == _port_run(corpus, 5, 20)
    mine = []
    for r in corpus[1]:
        aln = vg.Alignment.decode(got[r.seq_id])
        for m in aln.path.mapping:
            m.position.node_id //= 2
        mine.append(aln.encode())
    want = [a.encode() for a in
            stream.read_messages(str(MA / "out_b5_B20.gam"), vg.Alignment)]
    assert mine == want


def test_long_mode_on_a_mesh(monkeypatch):
    """Long-read mode (window 4) on 4 shards, with ramp rewinds: each
    window's lanes walk with their shard; the GAM bytes equal the port's
    one-device long mode."""
    from graphaligner_tpu_torch.utils import trace

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    graph, reads, seeds = _sim()
    corpus = (graph, reads[:10], seeds)
    trace.enable()
    trace.reset()
    try:
        got = _port_run(corpus, 5, 20, mesh=_cpu_mesh(4), window=4)
        st = trace.snapshot()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert st["long.lane_windows"] > st["long.lanes"] > 0
    assert got == _port_run(corpus, 5, 20, window=4)
    assert sum(v is not None for v in got.values()) == 10


def test_window_sizes_do_not_depend_on_the_mesh():
    """The long-mode window and the walk's fit read only Cm and Nm: a
    mesh changes neither (nor the capacity ladder)."""
    from graphaligner_tpu_torch.core.batch_align import BandedBatchAligner

    graph, reads, _ = _sim()
    one = BandedBatchAligner(graph, 35, 0, "cpu")
    many = BandedBatchAligner(graph, 35, 0, mesh=_cpu_mesh(8))
    for seq_len in (64, 640, 64 * 400, 64 * 3000):
        problems = [("A" * seq_len, 2)]
        assert one._plan(problems) == many._plan(problems)
    while one is not None:
        assert (one.Cm, one.Nm, one.LONG_WINDOW) == (many.Cm, many.Nm,
                                                     many.LONG_WINDOW)
        one, many = one._next_tier(), many._next_tier()
    assert many is None


def test_shard_reads_aligner_matches_jax():
    """K3 on each shard of 8 (B=8, S=2) against the JAX package's
    shard_map run, and against one unsharded call of the port's."""
    import jax

    from graphaligner_tpu.core.engine import _READ_CODE, encode_read
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq
    from graphaligner_tpu.parallel import make_mesh as jax_make_mesh
    from graphaligner_tpu.parallel import (
        shard_reads_aligner as jax_shard_reads_aligner,
    )
    from graphaligner_tpu_torch.graph.bigraph import (
        load_alignment_graph as port_load,
    )
    from graphaligner_tpu_torch.parallel import shard_reads_aligner

    reads = load_fastq(str(SIM / "sim.fastq"))
    B, S = 8, 2
    codes = np.full((B, S * 64), _READ_CODE["N"], dtype=np.uint8)
    for i in range(B):
        s = reads[i].sequence[: S * 64 - 5]
        codes[i, : len(s)] = encode_read(s)
    mesh = jax_make_mesh(len(jax.devices()))
    _, jrun = jax_shard_reads_aligner(
        load_alignment_graph(str(SIM / "bubbles.vg")), mesh)
    with mesh:
        want = [np.asarray(x) for x in jrun(codes, num_slices=S)]
    ba, run = shard_reads_aligner(port_load(str(SIM / "bubbles.vg")),
                                  _cpu_mesh(8))
    got = [x.numpy() for x in run(codes, num_slices=S)]
    _, one = shard_reads_aligner(port_load(str(SIM / "bubbles.vg")),
                                 _cpu_mesh(1))
    alone = [x.numpy() for x in one(codes, num_slices=S)]
    for k in range(6):
        assert got[k].shape == (S, len(ba.sched.code), B)
        np.testing.assert_array_equal(got[k], want[k].view(np.int32),
                                      err_msg=str(k))
        np.testing.assert_array_equal(got[k], alone[k], err_msg=str(k))
    assert not got[6].any() and not bool(want[6])


def test_shard_banded_scan_matches_jax():
    """One banded round on 8 shards (8 sim problems, no reach table on
    either side) against the JAX package's shard_banded_scan."""
    import jax

    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.parallel import make_mesh as jax_make_mesh
    from graphaligner_tpu.parallel.mesh import (
        shard_banded_scan as jax_shard_banded_scan,
    )
    from graphaligner_tpu_torch.graph.bigraph import (
        load_alignment_graph as port_load,
    )
    from graphaligner_tpu_torch.parallel.mesh import shard_banded_scan
    from test_torch_engine_banded import _plain_inputs, _problems
    from test_torch_engine_banded import _sim as jax_sim

    Nm, Cm = 32, 192
    mesh = jax_make_mesh(len(jax.devices()))
    tables, jrun = jax_shard_banded_scan(
        load_alignment_graph(str(SIM / "bubbles.vg")), mesh, Nm=Nm, Cm=Cm)
    graph, reads, seeds = jax_sim()
    args, S_max, _ = _plain_inputs(tables, _problems(graph, reads, seeds, 8),
                                   Nm, Cm)
    with mesh:
        want = jrun(*args, S_max=S_max)
    _, run = shard_banded_scan(port_load(str(SIM / "bubbles.vg")),
                               _cpu_mesh(8), Nm=Nm, Cm=Cm)
    got = run(*args, S_max=S_max)
    assert set(got) == set(want)
    for key in sorted(want):
        have, ref = got[key].numpy(), np.asarray(want[key])
        assert have.dtype == ref.dtype, key
        np.testing.assert_array_equal(have, ref, err_msg=key)
