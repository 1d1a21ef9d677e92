"""The port's iterative band projection against graphaligner_tpu's.

Where a graph has no reach table the port's banded scan projects each
band with ``ops.project_band`` (its plain version on the CPU), and the JAX
package with its ``pairwise`` mode. The same graph tables and seeded
problems go through both scans and every output must be identical
(tolerance zero: all integer) on every lane: plain and segmented lanes,
lanes past the band's Nm slots, inactive lanes, and topo ranks past
2,097,151. End to end, the seeded aligner without a reach table gives the
reference binary's goldens on sim.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from graphaligner_tpu.core.engine_banded import (
    I32MAX,
    PRI_RANGE,
    banded_scan as jax_banded_scan,
    build_graph_tables,
)
from graphaligner_tpu.io import stream, vg
from graphaligner_tpu_torch.core.engine_banded import banded_scan
from graphaligner_tpu_torch.core.tables import device_tables, reach_fits
from graphaligner_tpu_torch.ops import project_band as pb
from graphaligner_tpu_torch.ops.project_band import project_band_plain
from test_torch_engine_banded import (
    BW,
    _cyclic,
    _plain_inputs,
    _problems,
    _segmented_inputs,
    _sim,
)

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from biggraph_util import make_big_graph, make_reads  # noqa: E402

FIX = pathlib.Path(__file__).parent / "fixtures"
SIM = FIX / "sim"
CEILING = int(I32MAX) // PRI_RANGE  # 2,097,151: rank * 1024 overflows int32


def _big():
    """make_big_graph(2000) with reads of 512 bp seeded at their first
    backbone node; its topo ranks are offset past CEILING by the test."""
    graph, backbone, seq = make_big_graph(2000)
    reads = make_reads(seq, 4, 512, graph, backbone)
    from graphaligner_tpu.io.fastq import FastQ

    fq = [FastQ(seq_id=n, sequence=s, quality="!") for n, s, _ in reads]
    return graph, fq, {n: [(node, 0, False)] for n, _, node in reads}


CORPORA = {"sim": _sim, "cyclic": _cyclic, "big": _big}


def _compare(corpus, mode, Nm, Cm, nprob, monkeypatch, rank_offset=0,
             I_proj=pb.I_PROJ):
    """Runs both scans without a reach table, the projection capped at
    I_proj trips; returns the JAX outputs and the projection calls the
    port made."""
    monkeypatch.setenv("GA_FORCE_PALLAS", "1")
    monkeypatch.setattr(pb, "I_PROJ", I_proj)
    calls = []

    def count(*a, **kw):
        calls.append(a)
        return project_band_plain(*a, **kw)

    monkeypatch.setattr(pb, "project_band_plain", count)
    graph, reads, seeds = CORPORA[corpus]()
    tables = build_graph_tables(graph)
    if rank_offset:
        # ranks are only compared: a constant offset must change nothing
        tables.topo_rank = tables.topo_rank + np.int32(rank_offset)
    problems = _problems(graph, reads, seeds, nprob)
    make = _plain_inputs if mode == "plain" else _segmented_inputs
    args, S_max, seg = make(tables, problems, Nm, Cm)
    if seg is None:
        # lane 0 stops two slices early: inactive on the scan's last ones
        steps = args[2].copy()
        steps[0] = max(1, steps[0] - 2)
        args = (*args[:2], steps, *args[3:])
    ref = jax_banded_scan(
        *tables.device_args(), *args, S_max=S_max, Nm=Nm, Cm=Cm,
        _proj="pairwise", reach=None, seg=seg, tie8=(mode == "segmented"),
        I_proj=I_proj,
    )
    dt = device_tables(tables, None, "cpu")
    assert dt.reach is None
    got = banded_scan(dt, *args, S_max=S_max, Nm=Nm, Cm=Cm, seg=seg,
                      tie8=(mode == "segmented"))
    assert set(got) == set(ref)
    for key in sorted(ref):
        want = np.asarray(ref[key])
        have = got[key].numpy()
        assert have.dtype == want.dtype, key
        np.testing.assert_array_equal(have, want, err_msg=key)
    assert len(calls) == S_max
    return {k: np.asarray(v) for k, v in ref.items()}, args, seg, calls


@pytest.mark.parametrize("corpus,mode", [("sim", "plain"),
                                         ("sim", "segmented"),
                                         ("cyclic", "plain"),
                                         ("cyclic", "segmented")])
def test_banded_scan_without_reach_matches_jax_pairwise(corpus, mode,
                                                        monkeypatch):
    # 3 problems: a segmented lane holds one of them only
    nprob = 4 if mode == "plain" else 3
    ref, args, seg, _ = _compare(corpus, mode, 32, 192, nprob, monkeypatch)
    # lanes that are inactive on some slices of the scan
    active = (seg[0] == 1 if seg is not None else
              np.arange(len(ref["control"]))[:, None] < args[2][None, :])
    assert not active.all()


@pytest.mark.parametrize("corpus,Nm", [("sim", 6), ("sim", 8)])
def test_banded_scan_without_reach_over_lanes(corpus, Nm, monkeypatch):
    """Bands past Nm slots: the projection flags the lane over (and keeps
    relaxing it while the live lanes do), on every lane as in JAX."""
    ref, _, _, calls = _compare(corpus, "plain", Nm, 192, 6, monkeypatch)
    assert ref["overflow"].any()
    # some call had an over lane beside a live one: the coupled stop rule
    over_beside_live = 0
    for a in calls:
        _, over = project_band_plain(*a)
        over_beside_live += bool(over.any() and (~over & a[5]).any())
    assert over_beside_live


@pytest.mark.parametrize("cap", [1, 3])
def test_banded_scan_without_reach_at_a_low_trip_cap(cap, monkeypatch):
    """A live lane still changing at the trip cap is flagged over: with
    the cap cut to 1 or 3 trips some lanes end that way, and every output
    still equals the JAX scan at the same I_proj."""
    _, _, _, calls = _compare("sim", "plain", 32, 192, 4, monkeypatch,
                              I_proj=cap)
    capped = 0
    for a in calls:
        _, over = project_band_plain(*a)
        monkeypatch.setattr(pb, "I_PROJ", 32)
        _, over_full = project_band_plain(*a)
        monkeypatch.setattr(pb, "I_PROJ", cap)
        capped += int((over & ~over_full).sum())
    assert capped


def test_banded_scan_without_reach_past_rank_ceiling(monkeypatch):
    """make_big_graph(2000) with every topo rank offset past 2,097,151,
    where rank * 1024 no longer fits an int32: the plain version's int64
    key and the JAX pairwise compare give the same bands."""
    _, _, _, calls = _compare("big", "plain", 32, 288, 4, monkeypatch,
                              rank_offset=CEILING + 7)
    assert int(calls[0][8].min()) > CEILING


def test_project_band_wrapper_takes_plain_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; a wrong shape or dtype raises."""
    graph, reads, seeds = _sim()
    tables = build_graph_tables(graph)
    dt = device_tables(tables, None, "cpu")
    rng = np.random.default_rng(3)
    B, Nm = 6, 32
    ids = np.full((B, Nm), 2**31 - 1, np.int32)
    for b in range(B):
        n = int(rng.integers(1, 6))
        ids[b, :n] = np.sort(rng.choice(np.arange(1, graph.node_count - 1),
                                        n, replace=False))
    t = torch.as_tensor
    nmin = t(rng.integers(0, 40, (B, Nm)).astype(np.int32))
    nend = nmin + t(rng.integers(0, 30, (B, Nm)).astype(np.int32))
    args = (t(ids), nmin, nend, t(np.full(B, 5, np.int32)),
            t(np.full(B, BW, np.int32)),
            t(np.array([1, 1, 0, 1, 0, 1], bool)), dt.out_nbrs, dt.node_len,
            dt.topo_rank)
    n0 = pb.LAUNCHES
    got = pb.project_band(*args)
    want = pb.project_band_plain(*args)
    assert pb.LAUNCHES == n0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # strided views, as the scan passes its [Nm, B] carries transposed
    got_t = pb.project_band(*(a.T.contiguous().T for a in args[:3]),
                            *args[3:])
    assert torch.equal(got_t[0], want[0])
    with pytest.raises(ValueError, match="act"):
        pb.project_band(*args[:5], args[5].int(), *args[6:])


@pytest.mark.parametrize("top_rank", [2_625_000, 2**31 - 2])
def test_sort_key_orders_as_the_stable_rank_pri_sort(top_rank):
    """The kernel's packed key (rank << 32 | pri << 22 | concatenation
    index) orders a lane's entries exactly as project_band_plain's stable
    sort on rank * PRI_RANGE + pri: at the big graph's top rank and at the
    int32 ceiling, pri 0 to INF_PRI - 1 with ties within a node, and
    indices up to 2**22 - 1 (the entries a subsequence of the
    concatenation, in its order)."""
    rng = np.random.default_rng(top_rank % 1000)
    n = 20_000
    idx = np.sort(rng.choice(2**22, n, replace=False))
    idx[0], idx[-1] = 0, 2**22 - 1
    ranks = np.array([0, 1, top_rank - 1, top_rank] +
                     list(rng.integers(0, top_rank, 60)), np.int64)
    rank = torch.as_tensor(rng.choice(ranks, n))
    pri = torch.as_tensor(rng.choice([0, 1, 511, 1021, pb.INF_PRI - 1], n))
    key = pb.sort_key(rank, pri, torch.as_tensor(idx))
    assert int(key.max()) < 2**63 and len(key.unique()) == n
    want = torch.sort(rank * pb.PRI_RANGE + pri, stable=True).indices
    assert torch.equal(torch.sort(key).indices, want)
    assert pb.sort_key(top_rank, pb.INF_PRI - 1, 2**22 - 1) < \
        pb.sort_key(top_rank + 1, 0, 0)


def test_project_smem_and_its_raise_name_the_out_degree_limit():
    """A projection block's shared bytes (an int64 key and two int32
    fields an entry, four slot tables a lane), its lanes halving to fit,
    and past out-degree 452 at Nm=32 the raise naming out-degree, Nm and
    bytes."""
    assert pb.project_smem(32, 2, 1) == 16 * 32 * 3 + 16 * 32
    assert pb.project_lanes(32, 2) == pb.PROJ_LANES == 4
    assert pb.project_lanes(32, 80) == 4
    assert pb.project_lanes(32, 200) == 2
    assert pb.project_lanes(32, 452) == 1
    assert pb.project_smem(32, 452, 1) <= pb.SMEM_LIMIT
    need = pb.project_smem(32, 453, 1)
    assert need > pb.SMEM_LIMIT
    with pytest.raises(NotImplementedError,
                       match=f"out-degree 453, Nm=32 take {need} bytes"):
        pb.project_lanes(32, 453)
    assert pb.project_lanes(8, 453) == 2


def test_reach_fits_at_the_packed_key_ceiling():
    assert reach_fits(CEILING - 2)
    assert not reach_fits(CEILING - 1)  # JAX: N >= I32MAX // PRI_RANGE - 1


def test_device_tables_refuse_reach_past_the_ceiling(monkeypatch):
    """A reach table passed for a graph past reach_fits is a caller's
    mistake (the scan would not use it): device_tables raises (sim stands
    in for a graph of 2,097,150 nodes)."""
    from graphaligner_tpu_torch.core import reach as port_reach
    from graphaligner_tpu_torch.core import tables as port_tables

    graph, _, _ = _sim()
    tables = build_graph_tables(graph)
    reach = port_reach.ensure_reach(tables, BW + 64 - 1)
    assert reach is not None
    assert device_tables(tables, reach, "cpu").reach is not None
    monkeypatch.setattr(port_tables, "reach_fits", lambda n: False)
    with pytest.raises(ValueError, match="reach_fits"):
        device_tables(tables, reach, "cpu")
    assert device_tables(tables, None, "cpu").reach is None


def _by_name(path):
    return {a.name: a for a in stream.read_messages(str(path), vg.Alignment)}


def _align_sim(bw, ramp):
    from graphaligner_tpu_torch.core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
    )
    from graphaligner_tpu_torch.graph import load_alignment_graph
    from graphaligner_tpu_torch.io import load_fastq
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits

    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    aligner = BandedBatchAligner(graph, bw, ramp, "cpu")
    res = align_reads_seeded_batch(graph, aligner, reads, seeds)
    out = {}
    for r in reads:
        if res[r.seq_id].alignment_failed:
            continue
        a = vg.Alignment.decode(res[r.seq_id].alignment.encode())
        for m in a.path.mapping:
            m.position.node_id //= 2
        out[r.seq_id] = a
    return aligner, out


@pytest.mark.parametrize("bw,ramp,golden", [(35, 0, "golden_b35"),
                                            (5, 20, "golden_b5_B20")])
def test_sim_without_reach_table_matches_goldens(bw, ramp, golden,
                                                 monkeypatch):
    """GA_REACH_MAXN=0 (no graph gets a reach table): the seeded aligner
    projects every band iteratively and writes the reference goldens."""
    from graphaligner_tpu_torch.core import batch_align as ba

    monkeypatch.setenv("GA_REACH_MAXN", "0")
    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    calls = []

    def count(*a, **kw):
        calls.append(1)
        return project_band_plain(*a, **kw)

    monkeypatch.setattr(pb, "project_band_plain", count)
    fb0 = ba.host_fallback_count()
    aligner, out = _align_sim(bw, ramp)
    assert aligner._dt.reach is None and calls
    assert ba.host_fallback_count() == fb0
    assert out == _by_name(SIM / golden / "out.gam")


def test_aligner_builds_no_reach_table_past_the_ceiling(monkeypatch):
    """Past reach_fits the aligner does not build the reach table the
    scan would not use (sim stands in for a graph of 2,097,150 nodes)."""
    from graphaligner_tpu_torch.core import batch_align as ba

    built = []
    monkeypatch.setattr(ba, "reach_fits", lambda n: False)
    monkeypatch.setattr(ba, "ensure_reach",
                        lambda *a, **kw: built.append(1))
    aligner, out = _align_sim(35, 0)
    assert not built and aligner._dt.reach is None
    assert out == _by_name(SIM / "golden_b35" / "out.gam")


def test_project_band_launch_needs_nvcc(monkeypatch):
    """Where the kernel cannot be built the launch raises, naming nvcc,
    and counts nothing."""
    from graphaligner_tpu_torch.ops import _build

    def no_nvcc(name):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "library", no_nvcc)
    z = lambda *s, dtype=torch.int32: torch.zeros(s, dtype=dtype)  # noqa
    B, Nm, N = 2, 4, 8
    n0 = pb.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        pb._launch(z(B, Nm), z(B, Nm), z(B, Nm), z(B), z(B),
                   z(B, dtype=torch.bool), z(N, 2), z(N), z(N))
    assert pb.LAUNCHES == n0
