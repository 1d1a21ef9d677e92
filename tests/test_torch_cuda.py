"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides at run time whether there is a GPU and
skips without one (CUDA kernels have no interpret mode). On a machine with
an H100, which has no jax (``tests/conftest.py`` imports it, hence
``--noconftest``): ``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from test_torch_banded_cell import _random_slice_args

FIX = pathlib.Path(__file__).parent / "fixtures"
SIM = FIX / "sim"
K1_OUTS = ("cols", "nm", "ctrl", "p_ids", "p_cell_send", "p_node_min",
           "p_node_end", "p_min")
NAMES = ("vp_lo", "vp_hi", "vn_lo", "vn_hi", "sbs", "send", "nonconv")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _k1_matches_plain(args, P_fix=16):
    from graphaligner_tpu_torch.ops import banded_cell as k1

    n0 = k1.LAUNCHES
    got = k1.slice_cells(*args, P_fix=P_fix)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == n0 + 1
    want = k1.slice_cells_plain(*args, P_fix=P_fix)
    for name, g, w in zip(K1_OUTS, got, want):
        assert torch.equal(g, w), name


def _recorded_slices(cuda, graph, reads, seeds, monkeypatch, Nm=32, Cm=288):
    """Every slice_cells call of the port's scan over ``reads`` (one lane
    each, seeded at their first seed) on the card."""
    from graphaligner_tpu_torch.core import engine_banded as eb
    from graphaligner_tpu_torch.core.align import _pad_to_word
    from graphaligner_tpu_torch.core.engine import encode_read
    from graphaligner_tpu_torch.core.reach import ensure_reach
    from graphaligner_tpu_torch.core.tables import (
        build_graph_tables, device_tables, make_seed_carry,
    )

    calls = []
    orig = eb.slice_cells

    def rec(*args, **kw):
        calls.append([a.clone() for a in args])
        return orig(*args, **kw)

    monkeypatch.setattr(eb, "slice_cells", rec)
    tables = build_graph_tables(graph)
    reach = ensure_reach(tables, 35 + 63)
    probs = []
    for r in reads:
        node_id, pos, rev = seeds[r.seq_id][0]
        probs.append((_pad_to_word(r.sequence[pos:]),
                      graph.node_lookup[node_id * 2 + (1 if rev else 0)]))
    B = len(probs)
    S = max(len(p[0]) // 64 for p in probs)
    codes = np.full((B, S * 64), 14, np.uint8)
    seq_len, steps, starts = (np.zeros(B, np.int32) for _ in range(3))
    for i, (seq, node) in enumerate(probs):
        codes[i, : len(seq)] = encode_read(seq)
        seq_len[i], steps[i], starts[i] = len(seq), len(seq) // 64, node
    eb.banded_scan(
        device_tables(tables, reach, cuda), codes, seq_len, steps,
        np.zeros(B, np.int32), np.full((S, B), 35, np.int32),
        *make_seed_carry(tables, starts, Nm, Cm), S_max=S, Nm=Nm, Cm=Cm,
    )
    assert len(calls) == S
    return calls


@pytest.mark.cuda
def test_slice_cells_kernel_matches_plain_on_recorded_sim_slices(
        cuda, monkeypatch):
    """The fused K1 against slice_cells_plain on every slice of a scan over
    the 20 sim reads: all eight outputs bit for bit."""
    from graphaligner_tpu_torch.graph import load_alignment_graph
    from graphaligner_tpu_torch.io import load_fastq
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits

    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    for args in _recorded_slices(cuda, graph, reads, seeds, monkeypatch):
        _k1_matches_plain(args)


@pytest.mark.cuda
def test_slice_cells_kernel_matches_plain_on_cyclic_back_edges(
        cuda, monkeypatch):
    """The fused K1's per-lane fixpoint against the plain version's global
    loop on sim/cyclic.gfa (reads through the repeat twice, so bands carry
    back edges), at the default pass cap and cut to one extra pass."""
    from graphaligner_tpu_torch.graph import graph_from_gfa_file
    from graphaligner_tpu_torch.io import load_fastq

    graph = graph_from_gfa_file(str(SIM / "cyclic.gfa"))
    reads = load_fastq(str(FIX / "torch" / "cyclic_i" / "reads.fastq"))[:8]
    seeds = {r.seq_id: [(6, 0, False)] for r in reads}
    calls = _recorded_slices(cuda, graph, reads, seeds, monkeypatch)
    for args in calls:
        _k1_matches_plain(args)
        _k1_matches_plain(args, P_fix=1)


@pytest.mark.cuda
@pytest.mark.parametrize("K_in", [2, 5])
def test_slice_cells_kernel_matches_plain_random(cuda, K_in):
    """The fused K1 on a seeded random graph of in-degree K_in, random
    bands, carries and Eq windows, at Cm=288, Nm=32, B=512."""
    rng = np.random.default_rng(K_in)
    args = [torch.from_numpy(a).to(cuda)
            for a in _random_slice_args(rng, 60, K_in, 32, 288, 512)]
    _k1_matches_plain(args)


def _decode(graph, args, moves, used, lanes):
    """Decoded traces {lane: (w, r)} of a K2 call's ``lanes`` (through
    native.decode_moves_batch, as core.batch_align decodes a walk block),
    each from its start in the call's init_state; tensors or arrays."""
    from graphaligner_tpu_torch.core.tables import build_graph_tables
    from graphaligner_tpu_torch.io import native

    band, st = (np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                for a in (args[1], args[10]))
    moves = np.asarray(moves.cpu() if hasattr(moves, "cpu") else moves)
    used = np.asarray(used.cpu() if hasattr(used, "cpu") else used)
    lanes = np.asarray(lanes)
    node = band[st[0, lanes], st[2, lanes], lanes]
    start_w = np.asarray(graph.node_start)[node].astype(np.int64) + st[3, lanes]
    rows = min(moves.shape[0], int(np.max(used)) // 8 + 1)
    w, r, n = native.decode_moves_batch(
        np.ascontiguousarray(moves[:rows]).view(np.uint32),
        lanes.astype(np.int32), start_w,
        st[0, lanes].astype(np.int64) * 64 - 1,
        np.ascontiguousarray(graph.node_start, dtype=np.int64),
        np.ascontiguousarray(graph.node_end, dtype=np.int64),
        np.ascontiguousarray(graph.pos_to_node, dtype=np.int32),
        np.ascontiguousarray(build_graph_tables(graph).in_nbrs,
                             dtype=np.int32),
        int(band.shape[0] - 1) * 64 * 3 + 64, 4,
    )
    assert (n >= 1).all()
    return {int(b): (w[j, : n[j]].copy(), r[j, : n[j]].copy())
            for j, b in enumerate(lanes)}


def _assert_traces_equal(a, b):
    assert a.keys() == b.keys()
    for i in a:
        np.testing.assert_array_equal(a[i][0], b[i][0])
        np.testing.assert_array_equal(a[i][1], b[i][1])


def _k2_matches_per_lane_plain(args, kw, out=None):
    """The kernel's four outputs (``out``, or a launch now) bit for bit
    against walk_moves_plain at Bb=1, whose semantics are per lane."""
    from graphaligner_tpu_torch.ops import walk_moves as k2

    if out is None:
        n0 = k2.LAUNCHES
        out = k2.walk_moves(*args, **kw)
        torch.cuda.synchronize()
        assert k2.LAUNCHES == n0 + 1
    want = k2.walk_moves_plain(*args, **kw, Bb=1)
    for name, g, w in zip(("moves", "fail", "state_out", "used"), out, want):
        assert torch.equal(g, w), name
    return out


def _recorded_walks(cuda, graph, reads, seeds, bw, ramp, monkeypatch,
                    window=None):
    """(results, [(args, kwargs, outputs)] of every K2 call) of the seeded
    path over ``reads`` on the card, with no host fallback (in long mode
    when ``window`` is given: one call a window)."""
    from graphaligner_tpu_torch.core import batch_align as ba

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    walks = []
    orig = ba.walk_moves

    def rec(*args, **kw):
        out = orig(*args, **kw)
        walks.append(([a.clone() for a in args], kw, out))
        return out

    monkeypatch.setattr(ba, "walk_moves", rec)
    aligner = ba.BandedBatchAligner(graph, bw, ramp, cuda)
    if window is not None:
        aligner.LONG_WINDOW = window
    res = ba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    assert walks and aligner._long_mode == (window is not None)
    return res, walks


def _sim(bw=35, ramp=0):
    from graphaligner_tpu_torch.graph import load_alignment_graph
    from graphaligner_tpu_torch.io import load_fastq
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits

    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    return graph, reads, seeds


@pytest.mark.cuda
@pytest.mark.parametrize("bw,ramp,golden", [(35, 0, "golden_b35"),
                                            (5, 20, "golden_b5_B20")])
def test_sim_on_gpu_matches_goldens_and_walk_plain(cuda, bw, ramp, golden,
                                                   monkeypatch):
    """sim on the card: goldens byte for byte; every K2 call's four outputs
    bit for bit equal to the plain walk's at Bb=1 (per lane, as the kernel
    steps), and its decoded traces equal to those of the plain walk's
    lockstep blocks."""
    from graphaligner_tpu_torch.io import stream, vg
    from graphaligner_tpu_torch.ops import walk_moves as k2

    graph, reads, seeds = _sim()
    res, walks = _recorded_walks(cuda, graph, reads, seeds, bw, ramp,
                                 monkeypatch)
    gold = {a.name: a for a in
            stream.read_messages(str(SIM / golden / "out.gam"), vg.Alignment)}
    for r in reads:
        aln = vg.Alignment.decode(res[r.seq_id].alignment.encode())
        for m in aln.path.mapping:
            m.position.node_id //= 2
        assert aln == gold[r.seq_id]
    for args, kw, out in walks:
        moves, fail, _, used = _k2_matches_per_lane_plain(args, kw, out)
        p_moves, p_fail, _, p_used = k2.walk_moves_plain(*args, **kw)
        assert torch.equal(fail, p_fail)
        st = args[10].cpu().numpy()
        live = np.nonzero((fail[0].cpu().numpy() == 0) & (st[5] == 0))[0]
        _assert_traces_equal(_decode(graph, args, moves, used, live),
                             _decode(graph, args, p_moves, p_used, live))


@pytest.mark.cuda
def test_walk_kernel_window_chain(cuda, monkeypatch):
    """K2 across a window chain on the card: the sim -b 35 walk's table
    split at a middle slice m, the upper window (win_base m) walked from
    the call's state, the lower one from the kernel's state_out. Each
    window bit for bit equal to the plain walk at Bb=1; the two move
    streams concatenated decode as the single-window walk does."""
    graph, reads, seeds = _sim()
    _, walks = _recorded_walks(cuda, graph, reads, seeds, 35, 0, monkeypatch)
    args, kw, whole = walks[0]
    st = args[10].cpu().numpy()
    live = np.nonzero(st[5] == 0)[0]
    m = int(st[0, live][st[0, live] >= 4].min()) // 2
    assert m >= 1 and (st[0, live] <= m).any()
    upper = [a[m:] if i < 6 else a for i, a in enumerate(args)]
    upper[9] = torch.full_like(args[9], m)
    up = _k2_matches_per_lane_plain([a.contiguous() for a in upper], kw)
    lower = [a[: m + 1] if i < 6 else a for i, a in enumerate(args)]
    lower[10] = up[2]
    lo = _k2_matches_per_lane_plain([a.contiguous() for a in lower], kw)
    assert not bool(up[1].any())
    assert bool((up[2][0, live] <= m).all())
    ok = live[lo[1][0, live].cpu().numpy() == 0]
    assert torch.equal(lo[1], whole[1]) and len(ok)
    chained = torch.cat([up[0], lo[0]])
    _assert_traces_equal(
        _decode(graph, args, whole[0], whole[3], ok),
        _decode(graph, args, chained, [chained.shape[0] * 8 - 1], ok),
    )


@pytest.mark.cuda
def test_walk_kernel_at_top_capacity_tier(cuda, monkeypatch):
    """A recorded sim walk with its columns padded from Cm=288 to 2304, the
    top of the capacity ladder (66 KB of shared memory a lane): bit for bit
    equal to the plain walk at Bb=1 and to the unpadded call's outputs."""
    from graphaligner_tpu_torch.ops import walk_moves as k2

    graph, reads, seeds = _sim()
    _, walks = _recorded_walks(cuda, graph, reads, seeds, 35, 0, monkeypatch)
    args, kw, whole = walks[0]
    K1, F, Cm, B = args[0].shape
    padded = torch.zeros((K1, F, 2304, B), dtype=torch.int32, device=cuda)
    padded[:, :, :Cm] = args[0]
    assert k2.smem_bytes(2304, args[1].shape[1], args[6].shape[0]) > 7 * 2304 * 4
    out = _k2_matches_per_lane_plain([padded] + list(args[1:]), kw)
    for g, w in zip(out, whole):
        assert torch.equal(g, w)


def _bubble_chain(path, rng, bubbles=12, width=4):
    """A GFA chain of shared nodes (20-40 bp) joined by bubbles of
    ``width`` alleles (1-10 bp): every shared node past the first has
    in-degree ``width``. Returns the node list of each rank."""
    seqs, order, links = {}, [], []

    def node(lo, hi):
        nid = len(seqs) + 1
        seqs[nid] = "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi))))
        return nid

    prev = node(20, 41)
    order.append([prev])
    for _ in range(bubbles):
        alleles = [node(1, 11) for _ in range(width)]
        nxt = node(20, 41)
        links += [(prev, a) for a in alleles] + [(a, nxt) for a in alleles]
        order += [alleles, [nxt]]
        prev = nxt
    with open(path, "w") as f:
        for n, sq in seqs.items():
            f.write(f"S\t{n}\t{sq}\n")
        for a, b in links:
            f.write(f"L\t{a}\t+\t{b}\t+\t0M\n")
    return seqs, order


@pytest.mark.cuda
def test_walk_kernel_matches_plain_at_in_degree_4(cuda, monkeypatch,
                                                  tmp_path):
    """K2 at K_in = 4: a seeded random bubble chain (4 alleles a bubble,
    numpy seed 4) x 24 reads along random paths with 3 % substitutions,
    aligned on the card with no host fallback. Every K2 call bit for bit
    equal to the plain walk at Bb=1, with diagonal moves through
    in-neighbours 2 and 3 among its moves."""
    from graphaligner_tpu_torch.core.tables import build_graph_tables
    from graphaligner_tpu_torch.graph import graph_from_gfa_file
    from graphaligner_tpu_torch.io.fastq import FastQ

    rng = np.random.default_rng(4)
    seqs, order = _bubble_chain(tmp_path / "chain.gfa", rng)
    graph = graph_from_gfa_file(str(tmp_path / "chain.gfa"))
    assert build_graph_tables(graph).k_in == 4
    reads, seeds = [], {}
    for i in range(24):
        path = [o[int(rng.integers(0, len(o)))] for o in order]
        s = "".join(seqs[n] for n in path)
        mut = rng.random(len(s)) < 0.03
        s = "".join(str(rng.choice(list("ACGT"))) if m else c
                    for c, m in zip(s, mut))
        reads.append(FastQ(f"r{i}", s, "I" * len(s)))
        seeds[f"r{i}"] = [(path[0], 0, False)]
    res, walks = _recorded_walks(cuda, graph, reads, seeds, 35, 0,
                                 monkeypatch)
    assert not any(r.alignment_failed for r in res.values())
    codes = set()
    for args, kw, out in walks:
        assert kw["K_in"] == 4
        moves = _k2_matches_per_lane_plain(args, kw, out)[0]
        codes |= {int(c) for j in range(8)
                  for c in ((moves >> (4 * j)) & 15).unique()}
    assert {14, 15} <= codes


def _eq(cuda, codes, S):
    from graphaligner_tpu_torch.core import engine

    return torch.as_tensor(
        engine._build_eq_vectors(codes, engine._MATCH_TABLE, S).view(np.int32),
        device=cuda,
    )


@pytest.mark.cuda
def test_exhaustive_kernel_matches_plain(cuda):
    """K3's wavefront on bubbles x the 20 sim reads (S=11, B=20): all six
    slabs bit-identical to its plain version on the card, and the -i GAM
    equal to the JAX golden."""
    from graphaligner_tpu_torch.core import engine
    from graphaligner_tpu_torch.graph import load_alignment_graph
    from graphaligner_tpu_torch.io import load_fastq, stream, vg
    from graphaligner_tpu_torch.ops import exhaustive as k3

    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))
    ba = engine.BatchAligner(graph, cuda)
    S = max((len(r.sequence) + 63) // 64 for r in reads)
    codes = np.full((len(reads), S * 64), engine._READ_CODE["N"], np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r.sequence)] = engine.encode_read(r.sequence)
    eq = torch.as_tensor(
        engine._build_eq_vectors(codes, engine._MATCH_TABLE, S).view(np.int32),
        device=cuda,
    )
    kw = dict(num_nodes=ba.sched.num_nodes, cyclic=ba.sched.cyclic)
    assert not ba.sched.cyclic
    n0 = k3.LAUNCHES_WAVEFRONT
    got = k3.exhaustive(eq, *ba._dev_sched, **kw)
    torch.cuda.synchronize()
    assert k3.LAUNCHES_WAVEFRONT == n0 + 1
    want = k3.exhaustive_plain(eq, *ba._dev_sched, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    res = engine.align_batch_full_band(graph, reads, batch_aligner=ba)
    gold = {a.name: a.encode() for a in stream.read_messages(
        str(SIM.parent / "torch" / "sim_i" / "out.gam"), vg.Alignment)}
    for r, x in zip(reads, res):
        aln = x.alignment
        for m in aln.path.mapping:
            m.position.node_id //= 2
        assert aln.encode() == gold[r.seq_id]


@pytest.mark.cuda
def test_exhaustive_wavefront_crosses_slice_groups(cuda):
    """K3's wavefront on smallexample (P = 332, not a multiple of the chunk)
    at S = 40 (three groups of slice-warps, two seams) and B = 20 (not a
    multiple of the lanes a warp carries): bit-identical to the plain
    version."""
    from graphaligner_tpu_torch.core import engine
    from graphaligner_tpu_torch.graph import load_alignment_graph
    from graphaligner_tpu_torch.ops import exhaustive as k3

    ba = engine.BatchAligner(
        load_alignment_graph(str(FIX / "smallexample" / "sub_test.vg")), cuda)
    P = len(ba.sched.code)
    B, S = 20, 40
    assert P % k3.WAVE_CHUNK and S > k3.WAVE_WARPS and B % k3.WAVE_LANES
    rng = np.random.default_rng(8)
    codes = np.full((B, S * 64), engine._READ_CODE["N"], np.uint8)
    for i in range(B):
        n = int(rng.integers(S * 32, S * 64))
        codes[i, :n] = rng.integers(0, 4, n)
    eq = _eq(cuda, codes, S)
    num_nodes = ba.sched.num_nodes
    got = k3._launch_wavefront(eq, *ba._dev_sched, num_nodes=num_nodes)
    want = k3.exhaustive_plain(eq, *ba._dev_sched, num_nodes=num_nodes,
                               cyclic=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_exhaustive_kernel_cyclic_fixpoint_matches_plain(cuda):
    """K3's cyclic branch on the card: sim/cyclic.gfa x 16 random reads of
    3 slices (numpy seed 7). The six slabs and the flags equal the plain
    version's with no lane flagged; cut to one pass, every lane is flagged."""
    from graphaligner_tpu_torch.core import engine
    from graphaligner_tpu_torch.graph import graph_from_gfa_file
    from graphaligner_tpu_torch.ops import exhaustive as k3

    ba = engine.BatchAligner(graph_from_gfa_file(str(SIM / "cyclic.gfa")), cuda)
    assert ba.sched.cyclic
    B, S = 16, 3
    rng = np.random.default_rng(7)
    codes = np.full((B, S * 64), engine._READ_CODE["N"], np.uint8)
    for i in range(B):
        n = int(rng.integers(10, S * 64))
        codes[i, :n] = rng.integers(0, 4, n)
    eq = torch.as_tensor(
        engine._build_eq_vectors(codes, engine._MATCH_TABLE, S).view(np.int32),
        device=cuda,
    )
    kw = dict(num_nodes=ba.sched.num_nodes, cyclic=True)
    n0 = k3.LAUNCHES_SERIAL
    got = k3.exhaustive(eq, *ba._dev_sched, **kw)
    torch.cuda.synchronize()
    assert k3.LAUNCHES_SERIAL == n0 + 1
    want = k3.exhaustive_plain(eq, *ba._dev_sched, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not bool(got[6].any())
    assert bool(k3.exhaustive(eq, *ba._dev_sched, **kw, max_passes=1)[6].all())


def _cyclic_args(cuda, graph_file, B, S, seed):
    from graphaligner_tpu_torch.core import engine
    from graphaligner_tpu_torch.graph import load_alignment_graph

    ba = engine.BatchAligner(load_alignment_graph(graph_file), cuda)
    assert ba.sched.cyclic
    rng = np.random.default_rng(seed)
    codes = np.full((B, S * 64), engine._READ_CODE["N"], np.uint8)
    for i in range(B):
        n = int(rng.integers(10, S * 64))
        codes[i, :n] = rng.integers(0, 4, n)
    return (_eq(cuda, codes, S), *ba._dev_sched), ba.sched.num_nodes


@pytest.mark.cuda
@pytest.mark.parametrize("table_smem,store_smem", [(True, True),
                                                   (False, True),
                                                   (True, False),
                                                   (False, False)])
def test_exhaustive_cyclic_kernel_matches_plain_at_caps(cuda, monkeypatch,
                                                        table_smem,
                                                        store_smem):
    """K3's cyclic route on sim/cyclic.gfa x 20 random reads of 3 slices
    (numpy seed 9; 20 lanes leave the last warp part-full) at pass caps 1, 2
    and 128, with its node tables and store in shared or device memory: the
    six slabs and the flags bit for bit against the plain version, one
    counted launch each, every lane flagged at cap 1 and none at 128; every
    warp runs pass 1 over every position."""
    from graphaligner_tpu_torch.ops import exhaustive as k3

    monkeypatch.setattr(k3, "CYC_TABLE_SMEM", table_smem)
    monkeypatch.setattr(k3, "CYC_STORE_SMEM", store_smem)
    args, N = _cyclic_args(cuda, str(SIM / "cyclic.gfa"), 20, 3, 9)
    S, P, B = args[0].shape[0], args[1].shape[0], args[0].shape[3]
    assert k3.cyclic_shape(N, args[4].shape[1], B)[1:3] == (table_smem,
                                                            store_smem)
    for cap in (1, 2, 128):
        kw = dict(num_nodes=N, cyclic=True, max_passes=cap)
        n0 = k3.LAUNCHES_SERIAL
        got = k3.exhaustive(*args, **kw)
        torch.cuda.synchronize()
        assert k3.LAUNCHES_SERIAL == n0 + 1
        log = k3.PASS_LOG.cpu()
        want = k3.exhaustive_plain(*args, **kw)
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), (cap, name)
        if cap == 1:
            assert bool(got[6].all())
        if cap == 128:
            assert not bool(got[6].any())
        warps = -(-B // k3.WAVE_LANES)
        assert (log[:, 0, 0] == warps).all()
        assert (log[:, 0, 2] == warps * P).all()
        assert int(log[:, :, 0].sum()) >= warps * S * min(cap, 2)


@pytest.mark.cuda
def test_exhaustive_cyclic_kernel_matches_plain_on_circle(cuda, tmp_path):
    """K3's cyclic route on sim/bubbles.vg closed into a circle (its reverse
    strand's schedule runs against every edge: each pass moves a change one
    node on) x 12 random reads of 2 slices (numpy seed 4): bit for bit
    against the plain version, run on the CPU, with no lane flagged; later
    passes recompute fewer nodes than the first."""
    import importlib.util

    from graphaligner_tpu_torch.ops import exhaustive as k3

    spec = importlib.util.spec_from_file_location(
        "make_goldens", FIX / "torch" / "make_goldens.py")
    mg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mg)
    gfa = str(tmp_path / "circle.gfa")
    mg.write_circle_gfa(str(SIM / "bubbles.vg"), gfa)
    args, N = _cyclic_args(cuda, gfa, 12, 2, 4)
    kw = dict(num_nodes=N, cyclic=True)
    got = k3.exhaustive(*args, **kw)
    log = k3.PASS_LOG.cpu()
    want = k3.exhaustive_plain(*[a.cpu() for a in args], **kw)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g.cpu(), w), name
    assert not bool(want[6].any())
    later = log[:, 1:, 1]
    ran = log[:, 1:, 0] > 0
    assert ran.any()
    assert (later[ran] < log[:, :1, 1].expand_as(later)[ran]).all()


# long-read mode: chained scan rounds that drop their columns, and the walk
# that recomputes them a window at a time
LONGSIM = FIX / "longsim"


def _gam(path):
    from graphaligner_tpu_torch.io import stream, vg

    return stream.read_messages(str(path), vg.Alignment)


# huge's reads whose forward pieces project more than 32 band nodes at every
# capacity tier (K1 packs 32 node slots; the graph has 8-bp nodes): the JAX
# package realigns them with its host oracle, and the port, under
# GA_NO_FALLBACK=1, raises
HUGE_OVER_NM = ("read_1635367824", "read_604779437")


@pytest.mark.cuda
@pytest.mark.parametrize("graph_file,reads,seeds,golden", [
    ("graph.vg", "giant/giant_reads.fastq", "giant/giant_seeds.gam",
     "giant/giant_out.gam"),
    ("huge/graph.vg", "huge/reads.fastq", "huge/seeds.gam",
     "huge/golden.gam"),
], ids=["giant", "huge"])
def test_long_reads_on_gpu_match_reference(cuda, tmp_path, monkeypatch,
                                           graph_file, reads, seeds, golden):
    """30 kb (giant, ~468 slices) and 100 kb (huge, ~1,560 slices) reads
    through align_reads in long mode under GA_NO_FALLBACK=1, against the
    reference binary's alignments: giant's 3 reads, and the 2 of huge's 4
    whose lanes fit 32 band nodes (the other 2 raise, as the test below
    shows)."""
    from graphaligner_tpu_torch.core.params import AlignerParams
    from graphaligner_tpu_torch.io import load_fastq
    from graphaligner_tpu_torch.runtime.aligner import align_reads

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    keep = [r for r in load_fastq(str(LONGSIM / reads))
            if r.seq_id not in HUGE_OVER_NM]
    fastq = tmp_path / "reads.fastq"
    fastq.write_text("".join(f"@{r.seq_id}\n{r.sequence}\n+\n{r.quality}\n"
                             for r in keep))
    params = AlignerParams(
        graph_file=str(LONGSIM / graph_file),
        fastq_file=str(fastq),
        alignment_file=str(tmp_path / "out.gam"),
        seed_file=str(LONGSIM / seeds),
        initial_bandwidth=35,
    )
    align_reads(params, log=lambda m: None, output_dir=str(tmp_path),
                backend="cuda")
    names = {r.seq_id for r in keep}
    assert ([repr(a) for a in _gam(LONGSIM / golden) if a.name in names]
            == [repr(a) for a in _gam(tmp_path / "out.gam")])


@pytest.mark.cuda
@pytest.mark.parametrize("corpus,bw,ramp,over", [
    pytest.param("huge", 35, 0, HUGE_OVER_NM, id="huge-b35"),
    pytest.param("mega", 35, 0, ("read_1047316782", "read_390242688"),
                 id="mega-b35",
                 marks=pytest.mark.slow),
])
def test_long_reads_past_32_band_nodes_raise_without_fallback(
        cuda, monkeypatch, corpus, bw, ramp, over):
    """Lanes that project more than 32 band nodes at every capacity tier
    (huge's 2 reads, and both of mega's long lanes at -b 35, at slices 2
    and 3,009) have no device alignment: under GA_NO_FALLBACK=1 the run
    raises, naming one of them, instead of realigning it on the host."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.graph import load_alignment_graph
    from graphaligner_tpu_torch.io import load_fastq
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    d = LONGSIM / corpus
    graph = load_alignment_graph(str(d / "graph.vg"))
    reads = load_fastq(str(d / "reads.fastq"))
    seeds = load_seed_hits(str(d / "seeds.gam"), [r.seq_id for r in reads])
    aligner = ba.BandedBatchAligner(graph, bw, ramp, cuda)
    with pytest.raises(RuntimeError, match="GA_NO_FALLBACK") as err:
        ba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    assert any(repr(r) in str(err.value) for r in over)


@pytest.mark.cuda
def test_long_mode_redispatch_on_gpu_equals_the_originals(cuda, monkeypatch):
    """Each round of a long-mode chunk on the card (sim, window of 2), run
    again from its scan inputs: every output, the dropped ones included,
    bit for bit equal to the original's."""
    from graphaligner_tpu_torch.core import batch_align as ba

    graph, reads, seeds = _sim(5, 20)
    kept: dict = {}
    drop = ba._Round.drop

    def keep_then_drop(self, *keys):
        for key in keys:
            if key in self.out:
                kept.setdefault(id(self), {})[key] = self.out[key].clone()
        drop(self, *keys)

    monkeypatch.setattr(ba._Round, "drop", keep_then_drop)
    aligner = ba.BandedBatchAligner(graph, 5, 20, cuda)
    aligner.LONG_WINDOW = 2
    problems = [p for r in reads
                for p in ba.seed_extension_problems(graph, r.sequence,
                                                    seeds[r.seq_id][0])
                if p is not None]
    aligner._run(problems)
    assert len(aligner._chunk_rounds) >= 4
    for rnd in aligner._chunk_rounds:
        again = aligner._redispatch_round(rnd)
        orig = {**rnd.out, **kept.get(id(rnd), {})}
        assert set(orig) == set(again)
        for key, want in orig.items():
            assert torch.equal(again[key], want), key


@pytest.mark.cuda
def test_long_mode_walk_windows_match_plain(cuda, monkeypatch):
    """sim -b 5 -B 20 in long mode on the card (window of 4): the goldens
    byte for byte, and every window's K2 call bit for bit equal to the
    plain walk at Bb=1, its state chained from the newer window's."""
    from graphaligner_tpu_torch.io import stream, vg

    graph, reads, seeds = _sim()
    res, walks = _recorded_walks(cuda, graph, reads, seeds, 5, 20,
                                 monkeypatch, window=4)
    gold = {a.name: a for a in stream.read_messages(
        str(SIM / "golden_b5_B20" / "out.gam"), vg.Alignment)}
    for r in reads:
        aln = vg.Alignment.decode(res[r.seq_id].alignment.encode())
        for m in aln.path.mapping:
            m.position.node_id //= 2
        assert aln == gold[r.seq_id]
    chained = 0
    prev = None
    for args, kw, out in walks:
        _k2_matches_per_lane_plain(args, kw, out)
        if prev is not None:
            # lanes that walk on from the newer window's state_out
            carried = (args[10] == prev[2]).all(0) & (args[10][5] == 0)
            chained += int(carried.sum())
        prev = out
    assert len(walks) >= 3 and chained > 0


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("bw,ramp,golden", [(5, 20, "golden_b5B20.gam")])
def test_mega_reads_on_gpu_match_reference(cuda, monkeypatch, bw, ramp,
                                           golden):
    """1 Mbp reads (15,580 and 15,595 slices) on a 1.5 M-node graph of
    8-bp nodes at -b 5 -B 20 (ramp rewinds across dropped rounds), under
    GA_NO_FALLBACK=1, against the reference binary's alignments; prints the
    wall and the peak device memory above what the aligner's set-up holds.
    (At -b 35 both long lanes pass 32 band nodes: the test above.)"""
    import subprocess
    import time

    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.graph import load_alignment_graph
    from graphaligner_tpu_torch.io import load_fastq, vg
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    M = LONGSIM / "mega"
    graph = load_alignment_graph(str(M / "graph.vg"))
    reads = load_fastq(str(M / "reads.fastq"))
    seeds = load_seed_hits(str(M / "seeds.gam"), [r.seq_id for r in reads])
    gold = {a.name: a for a in _gam(M / golden)}
    t0 = time.time()
    rw0 = ba.rewind_count()
    aligner = ba.BandedBatchAligner(graph, bw, ramp, cuda)
    torch.cuda.synchronize(cuda)
    setup = time.time() - t0
    held = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    res = ba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    torch.cuda.synchronize(cuda)
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(cuda) - held
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"mega -b {bw} -B {ramp}: {len(reads)} reads in {wall:.1f} s "
          f"(set-up {setup:.1f} s), ramp rewinds {ba.rewind_count() - rw0}, "
          f"peak device memory {peak / 2**20:.1f} MiB above the set-up's "
          f"{held / 2**20:.1f} MiB [{card}]")
    assert ba.rewind_count() > rw0
    for r in reads:
        a = res[r.seq_id]
        if a.alignment_failed or a.alignment.score == 2**31 - 1:
            assert r.seq_id not in gold
            continue
        mine = vg.Alignment.decode(a.alignment.encode())
        for m in mine.path.mapping:
            m.position.node_id //= 2
        assert mine == gold[r.seq_id]
