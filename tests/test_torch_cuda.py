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

    wide = args[14].shape[1] > k1.NARROW_K_IN
    n0 = k1.LAUNCHES_WIDE if wide else k1.LAUNCHES
    got = k1.slice_cells(*args, P_fix=P_fix)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES_WIDE if wide else k1.LAUNCHES) == n0 + 1
    want = k1.slice_cells_plain(*args, P_fix=P_fix)
    for name, g, w in zip(K1_OUTS, got, want):
        assert torch.equal(g, w), name
    return got


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


def _repeat_in_neighbours(args, reps):
    """Rewrites the in_nbrs rows of three nodes of the fullest lane's band:
    each row lists a node of that band ``reps[i]`` times, then the row's
    first other entries (``core/tables.py::pad_adj`` keeps an edge listed
    twice, so a row may repeat an in-neighbour; rows stay -1 padded at
    their end)."""
    ids, in_nbrs = args[0], args[14]
    K_in = in_nbrs.shape[1]
    lane = int(np.argmax((ids < 2**31 - 1).sum(0)))
    band = ids[:, lane][ids[:, lane] < 2**31 - 1]
    assert len(band) > len(reps)
    for i, n in enumerate(reps):
        v, u = band[i + 1], band[i]
        row = [x for x in in_nbrs[v] if x >= 0 and x != u][: K_in - n]
        in_nbrs[v] = -1
        in_nbrs[v, : n + len(row)] = [u] * n + row


@pytest.mark.cuda
@pytest.mark.parametrize("K_in,Cm,B", [(2, 288, 512), (5, 288, 512),
                                       (8, 288, 512), (32, 288, 512),
                                       (80, 288, 64), (80, 1152, 64),
                                       (200, 1152, 64)],
                         ids=["2", "5", "8", "32", "80", "80-Cm1152",
                              "200-Cm1152"])
def test_slice_cells_kernel_matches_plain_random(cuda, K_in, Cm, B):
    """The fused K1 on a seeded random graph of in-degree K_in, random
    bands, carries and Eq windows, at Nm=32: the narrow route at 2 and 5,
    the wide one at 8 and 32 (B=512, Cm=288) and at 80 and 200 (B=64, Cm
    288 and 1152). Past 32 most rows keep 3 in-neighbours and every tenth
    node its whole row (a joining node; the plain version's cost grows
    with the in-neighbours any lane merges at a cell), and three rows
    repeat an in-band in-neighbour: twice, three times and 40 times (more
    in-band entries than a slot's list holds, so that node start reads its
    row again)."""
    rng = np.random.default_rng(K_in + Cm - 288)
    args = _random_slice_args(rng, max(60, K_in + 40), K_in, 32, Cm, B)
    if K_in > 32:
        in_nbrs = args[14]
        in_nbrs[np.arange(len(in_nbrs)) % 10 != 0, 3:] = -1
        _repeat_in_neighbours(args, [2, 3, 40])
    _k1_matches_plain([torch.from_numpy(a).to(cuda) for a in args])


def _decode(graph, args, moves, used, lanes):
    """Decoded traces {lane: (w, r)} of a K2 call's ``lanes`` (through
    native.decode_moves_batch, as core.batch_align decodes a walk block),
    each from its start in the call's init_state; tensors or arrays, the
    tables in the layout of the graph's route (``lane_major``)."""
    from graphaligner_tpu_torch.core.tables import build_graph_tables
    from graphaligner_tpu_torch.io import native
    from graphaligner_tpu_torch.ops.walk_moves import (
        code_bits,
        codes_per_word,
        lane_major,
    )

    band, st = (np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                for a in (args[1], args[10]))
    moves = np.asarray(moves.cpu() if hasattr(moves, "cpu") else moves)
    used = np.asarray(used.cpu() if hasattr(used, "cpu") else used)
    lanes = np.asarray(lanes)
    k_in = build_graph_tables(graph).k_in
    node = (band[st[0, lanes], lanes, st[2, lanes]] if lane_major(k_in)
            else band[st[0, lanes], st[2, lanes], lanes])
    start_w = np.asarray(graph.node_start)[node].astype(np.int64) + st[3, lanes]
    per = codes_per_word(k_in)
    rows = min(moves.shape[0], int(np.max(used)) // per + 1)
    w, r, n = native.decode_moves_batch(
        np.ascontiguousarray(moves[:rows]).view(np.uint32),
        lanes.astype(np.int32), start_w,
        st[0, lanes].astype(np.int64) * 64 - 1,
        np.ascontiguousarray(graph.node_start, dtype=np.int64),
        np.ascontiguousarray(graph.node_end, dtype=np.int64),
        np.ascontiguousarray(graph.pos_to_node, dtype=np.int32),
        np.ascontiguousarray(build_graph_tables(graph).in_nbrs,
                             dtype=np.int32),
        max(int(band.shape[0] - 1) * 64 * 3 + 64, moves.shape[0] * per), 4,
        code_bits=code_bits(k_in),
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
        n0 = k2.LAUNCHES + k2.LAUNCHES_WIDE
        out = k2.walk_moves(*args, **kw)
        torch.cuda.synchronize()
        assert k2.LAUNCHES + k2.LAUNCHES_WIDE == n0 + 1
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


def _bubble_chain(path, rng, bubbles=12, width=4, shared=(20, 41)):
    """A GFA chain of shared nodes (``shared`` bp, the upper end excluded)
    joined by bubbles of ``width`` alleles (1-10 bp): every shared node past
    the first has in-degree ``width``. Returns the node list of each
    rank."""
    seqs, order, links = {}, [], []

    def node(lo, hi):
        nid = len(seqs) + 1
        seqs[nid] = "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi))))
        return nid

    prev = node(*shared)
    order.append([prev])
    for _ in range(bubbles):
        alleles = [node(1, 11) for _ in range(width)]
        nxt = node(*shared)
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


@pytest.mark.cuda
def test_walk_kernel_matches_plain_at_in_degree_8(cuda, monkeypatch,
                                                  tmp_path):
    """K2's wide route at K_in = 8: a seeded random bubble chain (8
    alleles a bubble, shared nodes of 60 to 100 bp so that a band holds at
    most 32 nodes, numpy seed 8) x 24 reads along random paths with 3 %
    substitutions, aligned on the card with no host fallback. Every K2
    call is the wide route's and bit for bit equal to the plain walk at
    Bb=1, with diagonal moves (byte codes 128 + k) through in-neighbours 5,
    6 and 7 among its moves; the decoded traces equal the plain walk's."""
    from graphaligner_tpu_torch.core.tables import build_graph_tables
    from graphaligner_tpu_torch.graph import graph_from_gfa_file
    from graphaligner_tpu_torch.io.fastq import FastQ
    from graphaligner_tpu_torch.ops import walk_moves as k2

    rng = np.random.default_rng(8)
    seqs, order = _bubble_chain(tmp_path / "chain.gfa", rng, width=8,
                                shared=(60, 101))
    graph = graph_from_gfa_file(str(tmp_path / "chain.gfa"))
    assert build_graph_tables(graph).k_in == 8
    reads, seeds = [], {}
    for i in range(24):
        path = [o[int(rng.integers(0, len(o)))] for o in order]
        s = "".join(seqs[n] for n in path)
        mut = rng.random(len(s)) < 0.03
        s = "".join(str(rng.choice(list("ACGT"))) if m else c
                    for c, m in zip(s, mut))
        reads.append(FastQ(f"r{i}", s, "I" * len(s)))
        seeds[f"r{i}"] = [(path[0], 0, False)]
    n0 = k2.LAUNCHES
    res, walks = _recorded_walks(cuda, graph, reads, seeds, 35, 0,
                                 monkeypatch)
    assert k2.LAUNCHES == n0
    assert not any(r.alignment_failed for r in res.values())
    codes = set()
    for args, kw, out in walks:
        assert kw["K_in"] == 8
        moves, fail, _, used = _k2_matches_per_lane_plain(args, kw, out)
        codes |= {int(c) for j in range(4)
                  for c in ((moves >> (8 * j)) & 255).unique()}
        st = args[10].cpu().numpy()
        live = np.nonzero((fail[0].cpu().numpy() == 0) & (st[5] == 0))[0]
        plain = k2.walk_moves_plain(*args, **kw, Bb=1)
        _assert_traces_equal(_decode(graph, args, moves, used, live),
                             _decode(graph, args, plain[0], plain[3], live))
    assert {133, 134, 135} <= codes


def _converging(K, n_reads, tmp_path, seed):
    """A seeded graph of 40 segments with a converging tree of K leaves
    in every other gap (in-degree K) and n_reads reads of 1,000 bp along
    random paths through it, one forward seed each."""
    from graphaligner_tpu_torch.graph import graph_from_gfa_file
    from graphaligner_tpu_torch.graph.synthetic import make_converging
    from graphaligner_tpu_torch.io.fastq import FastQ

    gfa, reads = make_converging(40, n_reads, 1000, seed,
                                 sites=[("tree", K), ("site", 3)] * 20)
    (tmp_path / "cv.gfa").write_text(gfa)
    graph = graph_from_gfa_file(str(tmp_path / "cv.gfa"))
    return (graph, [FastQ(n, s, "I" * len(s)) for n, s, _ in reads],
            {n: [(node, 0, False)] for n, _, node in reads})


@pytest.mark.cuda
@pytest.mark.parametrize("K", [33, 70])
def test_slice_cells_kernel_matches_plain_past_32_in_neighbours(
        cuda, monkeypatch, tmp_path, K):
    """K1's wide route past 32 in-neighbours (seven and 14 pred planes)
    against slice_cells_plain on every slice of a scan over 16 reads of a
    seeded converging-tree graph of in-degree K, at the Cm=1152 tier (a
    band across a tree holds several 40-80 bp nodes): all eight outputs
    bit for bit, with in-band in-neighbours past 32 (past 64 at 70) in the
    pred planes."""
    graph, reads, seeds = _converging(K, 16, tmp_path, 300 + K)
    calls = _recorded_slices(cuda, graph, reads, seeds, monkeypatch,
                             Cm=1152)
    assert calls[0][14].shape[1] == K
    NP, widest = -(-K // 5), -1
    for args in calls:
        nm = _k1_matches_plain(args)[1]
        for k in range(K):
            field = nm[4 + k // 5] >> (6 * (k % 5))
            if bool(((field >> 5) & 1).any()):
                widest = max(widest, k)
        assert nm.shape[0] == 4 + 2 * NP
    assert widest >= (64 if K > 64 else 32)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [33, 70])
def test_walk_kernel_matches_plain_past_32_in_neighbours(cuda, monkeypatch,
                                                         tmp_path, K):
    """K2's wide route past 32 in-neighbours (in chunks of 32; byte codes
    at 33, 16-bit codes at 70): a seeded converging-tree graph of
    in-degree K x 64 reads of 1,000 bp, aligned on the card with no host
    fallback. Every K2 call bit for bit, codes included, equal to the
    plain walk at Bb=1, with moves through in-neighbours past 32 (past 64
    at 70) among them; the decoded traces equal the plain walk's. Then the
    widest call again with rows that repeat an in-band in-neighbour 2, 3
    and 40 times (as the K1 random test's rows do), so that node-start
    candidate lists pass 32: bit for bit the plain walk's."""
    from graphaligner_tpu_torch.core.tables import build_graph_tables
    from graphaligner_tpu_torch.ops import walk_moves as k2

    graph, reads, seeds = _converging(K, 64, tmp_path, 200 + K)
    assert build_graph_tables(graph).k_in == K
    n0 = k2.LAUNCHES
    res, walks = _recorded_walks(cuda, graph, reads, seeds, 35, 0,
                                 monkeypatch)
    assert k2.LAUNCHES == n0
    assert not any(r.alignment_failed for r in res.values())
    bits = k2.code_bits(K)
    h0, d0 = k2.move_bases(K)
    ks = set()
    for args, kw, out in walks:
        assert kw["K_in"] == K
        moves, fail, _, used = _k2_matches_per_lane_plain(args, kw, out)
        m = moves.to(torch.int64) & 0xFFFFFFFF
        for j in range(32 // bits):
            c = (m >> (bits * j)) & ((1 << bits) - 1)
            for base in (h0, d0):
                hit = c[(c >= base) & (c < base + h0)]
                ks |= {int(x) - base for x in hit.unique()}
        st = args[10].cpu().numpy()
        live = np.nonzero((fail[0].cpu().numpy() == 0) & (st[5] == 0))[0]
        plain = k2.walk_moves_plain(*args, **kw, Bb=1)
        _assert_traces_equal(_decode(graph, args, moves, used, live),
                             _decode(graph, args, plain[0], plain[3], live))
    assert max(ks) >= (64 if K > 64 else 32)
    # the widest call with each slot's first in-band in-neighbour repeated
    # 2, 3 or 40 times (by slot) before its row: node-start lists of up
    # to 32 candidates with repeats, and past 32 (the whole row, in chunks)
    args, kw, _ = max(walks, key=lambda w: w[0][0].numel())
    rargs, rkw = _with_fields(args, kw, _repeat_first_in_band)
    fp = _pred_fields(k2.lane_last_tables(rargs[:6])[3], rkw["K_in"],
                      args[1].shape[2])
    assert bool((((fp >> 5) & 1).sum(1) > 32).any())
    out = _k2_matches_per_lane_plain(rargs, rkw)
    assert not bool(out[1].all())


def _pred_fields(planes, K, Nm):
    """A lane-last [S, P * Nm, B] pred table as [S, K, Nm, B] int64 6-bit
    fields (in-neighbour k's slot | valid << 5)."""
    S, PN, B = planes.shape
    w = planes.reshape(S, PN // Nm, Nm, B).to(torch.int64)
    k = torch.arange(K, device=planes.device)
    return (w[:, k // 5] >> (6 * (k % 5))[None, :, None, None]) & 63


def _pred_planes(fields):
    """The inverse of _pred_fields: [S, K, Nm, B] fields as [S, P * Nm, B]
    int32 planes."""
    S, K, Nm, B = fields.shape
    w = torch.zeros((S, -(-K // 5), Nm, B), dtype=torch.int64,
                    device=fields.device)
    for k in range(K):
        w[:, k // 5] |= fields[:, k] << (6 * (k % 5))
    return w.to(torch.int32).reshape(S, -1, B)


def _with_fields(args, kw, fn):
    """A lane-major K2 call whose pred and pred_prev fields ([S, K, Nm, B]
    each) fn rewrites, maybe to another in-degree: (args, kwargs)."""
    from graphaligner_tpu_torch.ops import walk_moves as k2

    assert k2.lane_major(kw["K_in"])
    tabs = list(k2.lane_last_tables(args[:6]))
    Nm = tabs[1].shape[1]
    fp, fq = fn(_pred_fields(tabs[3], kw["K_in"], Nm),
                _pred_fields(tabs[4], kw["K_in"], Nm))
    tabs[3], tabs[4] = _pred_planes(fp), _pred_planes(fq)
    return (list(k2.lane_major_tables(tabs)) + list(args[6:]),
            {**kw, "K_in": fp.shape[1]})


def _repeat_first_in_band(fp, fq, reps=(2, 3, 40)):
    """Slot j's first in-band field (pred and pred_prev) put reps[j % 3]
    times before its row, the rest of max(reps) front fields empty."""
    ok = (fp >> 5) & 1
    first = ok.argmax(1, keepdim=True)
    has = ok.amax(1, keepdim=True)
    j = torch.arange(fp.shape[2], device=fp.device)
    n = torch.tensor(reps, device=fp.device)[j % len(reps)]
    i = torch.arange(max(reps), device=fp.device)
    take = (i[:, None] < n[None, :])[None, :, :, None]

    def front(f):
        return torch.cat([torch.where(take, f.gather(1, first) * has, 0), f],
                         1)

    return front(fp), front(fq)


def _codes(moves, bits, n):
    """The first n move codes of each lane of a [T_w, B] move stream."""
    m = moves.to(torch.int64) & 0xFFFFFFFF
    per = 32 // bits
    c = torch.stack([(m >> (bits * j)) & ((1 << bits) - 1)
                     for j in range(per)], 1)
    return c.reshape(-1, moves.shape[1])[:n]


def _row0_diagonals_made_prev_only(graph, args, kw, out):
    """A lane-major wide K2 call in which each row-0 diagonal its walk
    (outputs ``out``) took at a node start, from node v's first cell at
    row 0 of slice q to in-neighbour u's last at row 63 of slice q - 1,
    with u in band in both slices, goes through u as a prev-only
    in-neighbour: for that lane, u's pred valid bit at v's slot of slice q
    cleared, its pred_prev field kept. No H or D through u was legal at v's
    start in q above row 0 (the walk went on to row 0 there), and the
    prev-only D weighs and lands as the in-band one, so the walk stays the
    same. Returns (args, kwargs, the number of diagonals changed)."""
    from graphaligner_tpu_torch.core.tables import build_graph_tables

    in_nbrs = build_graph_tables(graph).in_nbrs
    start, end = np.asarray(graph.node_start), np.asarray(graph.node_end)
    pos2node = np.asarray(graph.pos_to_node)
    st = args[10].cpu().numpy()
    live = np.nonzero((out[1][0].cpu().numpy() == 0) & (st[5] == 0))[0]
    band = args[1].cpu().numpy()  # [K+1, B, Nm]
    edits = []
    for b, (w, r) in _decode(graph, args, out[0], out[3], live).items():
        for i in range(1, len(w)):
            v, u = pos2node[w[i]], pos2node[w[i - 1]]
            if (r[i] % 64 or r[i - 1] != r[i] - 1 or w[i] != start[v]
                    or w[i - 1] != end[u] - 1):
                continue
            ks = np.nonzero(in_nbrs[v] == u)[0]
            js = np.nonzero(band[r[i] // 64 + 1, b] == v)[0]
            if len(ks) and len(js):
                edits.append((r[i] // 64 + 1, ks[0], js[0], b))
    made = []

    def fn(fp, fq):
        fp = fp.clone()
        for e in edits:
            if fp[e] & 32 and fq[e] & 32:
                fp[e] &= 31
                made.append(e)
        return fp, fq

    args, kw = _with_fields(args, kw, fn)
    return args, kw, len(made)


@pytest.mark.cuda
def test_walk_kernel_takes_prev_only_diagonal_past_32(cuda, monkeypatch,
                                                      tmp_path):
    """K2's wide route takes a row-0 diagonal into an in-neighbour present
    only in the previous band (pred_prev), through an in-neighbour index
    past 32: every K2 call of 64 reads over a seeded converging-tree graph
    of in-degree 33, each row-0 diagonal its walk took at a node start
    made prev-only (_row0_diagonals_made_prev_only), then its pred and
    pred_prev fields moved 33 places up (in-degree 66, 16-bit codes; the
    first 33 fields empty). Each call is bit for bit the plain walk's at
    Bb=1 and the same walk as the recorded one (fail, state_out and used
    equal, each node-start code through in-neighbour k there k + 33
    here); and removing its prev-only fields changes the outputs, so the
    prev-only diagonals were taken."""
    from graphaligner_tpu_torch.ops import walk_moves as k2

    graph, reads, seeds = _converging(33, 64, tmp_path, 233)
    _, walks = _recorded_walks(cuda, graph, reads, seeds, 35, 0, monkeypatch)
    shift = 33

    def up(fp, fq):
        z = torch.zeros_like(fp[:, :shift])
        return torch.cat([z, fp], 1), torch.cat([z, fq], 1)

    def no_prev_only(fp, fq):
        return fp, torch.where((fp >> 5) & 1 == 1, fq, 0)

    h0, d0 = k2.move_bases(33)
    h1, d1 = k2.move_bases(33 + shift)
    made = taken = 0
    for args, kw, out in walks:
        pargs, pkw, n = _row0_diagonals_made_prev_only(graph, args, kw, out)
        sargs, skw = _with_fields(pargs, pkw, up)
        assert skw["K_in"] == 66 and k2.code_bits(66) == 16
        got = _k2_matches_per_lane_plain(sargs, skw)
        for g, w in zip(got[1:], out[1:]):
            assert torch.equal(g, w)
        steps = int(out[3].max()) + 1
        c = _codes(out[0], 8, steps)
        want = torch.where((c >= h0) & (c < d0), c - h0 + h1 + shift, c)
        want = torch.where(c >= d0, c - d0 + d1 + shift, want)
        assert torch.equal(_codes(got[0], 16, steps), want)
        nargs, nkw = _with_fields(sargs, skw, no_prev_only)
        alt = k2.walk_moves(*nargs, **nkw)
        made += n
        taken += any(not torch.equal(a, b) for a, b in zip(got, alt))
    assert made and taken


@pytest.mark.cuda
def test_wide_walk_kernel_at_top_capacity_tier(cuda, monkeypatch, tmp_path):
    """K2's wide route at the top of the capacity ladder: the widest call
    below it of 64 reads over a seeded converging-tree graph of in-degree
    70, its first 128 lanes with their columns padded to Cm=2304 (two
    slice buffers of them): bit for bit equal to the plain walk at Bb=1
    and to the unpadded call's outputs."""
    from graphaligner_tpu_torch.ops import walk_moves as k2

    graph, reads, seeds = _converging(70, 64, tmp_path, 270)
    _, walks = _recorded_walks(cuda, graph, reads, seeds, 35, 0, monkeypatch)
    args, kw, _ = max((w for w in walks if w[0][0].shape[3] < 2304),
                      key=lambda w: w[0][0].numel())
    sub = [a if i == 6 else
           (a[:, :128] if i < 6 else a[..., :128]).contiguous()
           for i, a in enumerate(args)]
    K1, B, F, Cm = sub[0].shape
    assert Cm < 2304 and k2.lane_major(kw["K_in"])
    padded = torch.zeros((K1, B, F, 2304), dtype=torch.int32, device=cuda)
    padded[..., :Cm] = sub[0]
    Nm = sub[1].shape[2]
    assert k2.smem_bytes(2304, Nm, 0, 70) > 2 * 7 * 2304 * 4
    out = _k2_matches_per_lane_plain([padded] + sub[1:], kw)
    for g, w in zip(out, k2.walk_moves(*sub, **kw)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_project_band_kernel_matches_plain_past_32_out_neighbours(
        cuda, monkeypatch, tmp_path):
    """The projection kernel at K_out = 70 (the reverse strand of a
    segment that 70 leaves join: 2,272 entries a lane, 147 KB of shared
    memory a block of 4 lanes) against project_band_plain, bit for bit, on
    every call of a scan without a reach table over 8 reads of the
    converging-tree graph."""
    from graphaligner_tpu_torch.ops import project_band as pb

    graph, reads, seeds = _converging(70, 8, tmp_path, 270)
    calls = _recorded_projections(cuda, graph, reads, seeds, monkeypatch,
                                  Nm=32, rank_offset=0)
    assert calls[0][6].shape[1] == 70
    for args in calls:
        n0 = pb.LAUNCHES
        ids, over = pb.project_band(*args)
        torch.cuda.synchronize()
        assert pb.LAUNCHES == n0 + 2
        p_ids, p_over = pb.project_band_plain(*args)
        assert torch.equal(ids, p_ids) and torch.equal(over, p_over)


@pytest.mark.cuda
@pytest.mark.parametrize("K_out", [2, 80, 452])
def test_project_band_kernel_matches_plain_random(cuda, K_out):
    """The projection kernel against project_band_plain, bit for bit, on a
    seeded random graph of out-degree K_out (452: the most one lane's
    entries fit in a block at Nm=32) with topo ranks near the big graph's
    (2,625,000): 64 lanes of 32 slots, some inactive, some with few
    slots; two slots of each lane share an out-neighbour and their end
    score, so that node's entries tie in pri. Some lanes go over beside
    live ones."""
    from graphaligner_tpu_torch.ops import project_band as pb

    rng = np.random.default_rng(K_out)
    N, B, Nm, empty = 2 * K_out + 400, 64, 32, 2**31 - 1
    node_len = rng.integers(1, 40, N)
    topo_rank = 2_625_000 - N + rng.permutation(N)
    out_nbrs = np.full((N, K_out), -1)
    for v in range(N):
        deg = int(rng.choice([0, 1, 2, K_out, rng.integers(0, K_out + 1)]))
        out_nbrs[v, :deg] = rng.choice(N, deg, replace=False)
    p_ids = np.full((B, Nm), empty)
    p_nmin = rng.integers(0, 60, (B, Nm))
    p_nend = p_nmin + rng.integers(0, 30, (B, Nm))
    for b in range(B):
        k = int(rng.integers(2, Nm + 1)) if b % 4 else int(rng.integers(2, 5))
        band = rng.choice(N, k, replace=False)
        p_ids[b, :k] = band[np.argsort(topo_rank[band])]
        s1, s2 = rng.choice(k, 2, replace=False)
        x = int(rng.integers(N))
        for s in (s1, s2):
            row = [y for y in out_nbrs[p_ids[b, s]] if y >= 0 and y != x]
            out_nbrs[p_ids[b, s]] = -1
            out_nbrs[p_ids[b, s], : len(row[: K_out - 1]) + 1] = \
                [x] + row[: K_out - 1]
        p_nend[b, s2] = p_nend[b, s1]
        p_nmin[b, s2] = min(p_nmin[b, s2], p_nend[b, s2])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),  # noqa
                                  device=cuda)
    p_min = np.where(p_ids < empty, p_nmin, 99).min(1)  # the band's minimum
    args = (t(p_ids), t(p_nmin), t(p_nend), t(p_min),
            t(rng.choice([5, 20, 35], B)),
            torch.as_tensor(rng.random(B) < 0.85, device=cuda),
            t(out_nbrs), t(node_len), t(topo_rank))
    n0 = pb.LAUNCHES
    ids, over = pb.project_band(*args)
    torch.cuda.synchronize()
    assert pb.LAUNCHES == n0 + 2
    p_ids_, p_over = pb.project_band_plain(*args)
    assert torch.equal(ids, p_ids_) and torch.equal(over, p_over)
    assert bool(over.any()) and bool((~over & args[5]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("bw,ramp,golden", [(35, 0, "multiallelic_b35"),
                                            (5, 20, "multiallelic_b5_B20")])
def test_multiallelic_on_gpu_matches_golden(cuda, monkeypatch, bw, ramp,
                                            golden):
    """The multiallelic corpus (in-degree 8: 100 reads of about 10 kb) on
    the card against the JAX package's golden, byte for byte, with no host
    fallback, through both wide routes."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.graph import graph_from_gfa_file
    from graphaligner_tpu_torch.io import load_fastq, stream, vg
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import walk_moves as k2
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    d = FIX / "torch" / golden
    graph = graph_from_gfa_file(str(d / "graph.gfa"))
    reads = load_fastq(str(d / "reads.fastq"))
    seeds = load_seed_hits(str(d / "seeds.gam"), [r.seq_id for r in reads])
    n1, n2 = k1.LAUNCHES_WIDE, k2.LAUNCHES_WIDE
    res = ba.align_reads_seeded_batch(
        graph, ba.BandedBatchAligner(graph, bw, ramp, cuda), reads, seeds)
    assert k1.LAUNCHES_WIDE > n1 and k2.LAUNCHES_WIDE > n2
    gold = {a.name: a for a in
            stream.read_messages(str(d / "out.gam"), vg.Alignment)}
    assert len(gold) == len(reads)
    for r in reads:
        aln = vg.Alignment.decode(res[r.seq_id].alignment.encode())
        for m in aln.path.mapping:
            m.position.node_id //= 2
        assert aln == gold[r.seq_id], r.seq_id


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


def _recorded_projections(cuda, graph, reads, seeds, monkeypatch, Nm=32,
                          Cm=288, rank_offset=0, cut_lane0=2):
    """Every project_band call of the port's scan without a reach table
    over ``reads`` (one lane each, seeded at their first seed; lane 0
    stops ``cut_lane0`` slices early, so it is inactive on the last ones)
    on the card, with its arguments cloned."""
    from graphaligner_tpu_torch.core import engine_banded as eb
    from graphaligner_tpu_torch.core.align import _pad_to_word
    from graphaligner_tpu_torch.core.engine import encode_read
    from graphaligner_tpu_torch.core.tables import (
        build_graph_tables, device_tables, make_seed_carry,
    )

    calls = []
    orig = eb.project_band

    def rec(*args, **kw):
        calls.append([a.clone() for a in args])
        return orig(*args, **kw)

    monkeypatch.setattr(eb, "project_band", rec)
    tables = build_graph_tables(graph)
    tables.topo_rank = tables.topo_rank + np.int32(rank_offset)
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
    steps[0] = max(1, steps[0] - cut_lane0)
    eb.banded_scan(
        device_tables(tables, None, cuda), codes, seq_len, steps,
        np.zeros(B, np.int32), np.full((S, B), 35, np.int32),
        *make_seed_carry(tables, starts, Nm, Cm), S_max=S, Nm=Nm, Cm=Cm,
    )
    assert len(calls) == S
    return calls


def _big_corpus(n_segments=2000, n_reads=6, read_len=512):
    from graphaligner_tpu_torch.graph.synthetic import (
        make_big_graph, make_reads,
    )
    from graphaligner_tpu_torch.io.fastq import FastQ

    graph, backbone, seq = make_big_graph(n_segments)
    reads = make_reads(seq, n_reads, read_len, graph, backbone)
    return (graph, [FastQ(seq_id=n, sequence=s, quality="!")
                    for n, s, _ in reads],
            {n: [(node, 0, False)] for n, _, node in reads})


@pytest.mark.cuda
@pytest.mark.parametrize("corpus,Nm,rank_offset", [
    ("sim", 32, 0), ("sim", 8, 0), ("big", 32, 2**31 // 1024 + 7),
], ids=["sim", "sim-Nm8-over", "big-past-rank-2097151"])
def test_project_band_kernel_matches_plain_on_recorded_calls(
        cuda, monkeypatch, corpus, Nm, rank_offset):
    """The projection kernel against project_band_plain, bit for bit, on
    every call of a scan without a reach table: sim (an inactive lane on
    the last slices), sim at Nm=8 (over lanes beside live ones) and
    make_big_graph(2000) with its topo ranks past 2,097,151."""
    from graphaligner_tpu_torch.ops import project_band as pb

    graph, reads, seeds = _sim() if corpus == "sim" else _big_corpus()
    calls = _recorded_projections(cuda, graph, reads, seeds, monkeypatch,
                                  Nm=Nm, rank_offset=rank_offset)
    over_beside_live = inactive = 0
    for args in calls:
        n0 = pb.LAUNCHES
        ids, over = pb.project_band(*args)
        torch.cuda.synchronize()
        assert pb.LAUNCHES == n0 + 2  # mode 0 and mode 1
        p_ids, p_over = pb.project_band_plain(*args)
        assert torch.equal(ids, p_ids) and torch.equal(over, p_over)
        over_beside_live += bool(over.any() and (~over & args[5]).any())
        inactive += bool((~args[5]).any())
        if rank_offset:
            assert int(args[8].min()) > 2**31 // 1024
    assert inactive
    if Nm == 8:
        assert over_beside_live


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 2, 3])
def test_project_band_kernel_matches_plain_at_a_low_trip_cap(cuda,
                                                             monkeypatch,
                                                             cap):
    """The kernel's cap rule (a live lane still changing at the last trip
    is flagged over, the other lanes run on to the batch's count) against
    project_band_plain, bit for bit, on sim's recorded calls with the cap
    cut to 1-3 trips; some lanes end over by the cap alone."""
    from graphaligner_tpu_torch.ops import project_band as pb

    graph, reads, seeds = _sim()
    calls = _recorded_projections(cuda, graph, reads, seeds, monkeypatch,
                                  Nm=32, rank_offset=0)
    monkeypatch.setattr(pb, "I_PROJ", cap)
    capped = 0
    for args in calls:
        ids, over = pb.project_band(*args)
        p_ids, p_over = pb.project_band_plain(*args)
        assert torch.equal(ids, p_ids) and torch.equal(over, p_over)
        monkeypatch.setattr(pb, "I_PROJ", 32)
        _, over_full = pb.project_band_plain(*args)
        monkeypatch.setattr(pb, "I_PROJ", cap)
        capped += int((over & ~over_full).sum())
    assert capped


@pytest.mark.cuda
@pytest.mark.parametrize("bw,ramp,golden", [(35, 0, "golden_b35.gam"),
                                            (5, 20, "golden_b5B20.gam")])
def test_longsim_without_reach_on_gpu_matches_golden(cuda, monkeypatch, bw,
                                                     ramp, golden):
    """GA_REACH_MAXN=0: longsim's 100 reads (ONT's 25 at -b 5 -B 20) with
    every band projected by the kernel, under GA_NO_FALLBACK=1, against
    the reference binary's alignments."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.graph import load_alignment_graph
    from graphaligner_tpu_torch.io import load_fastq, vg
    from graphaligner_tpu_torch.ops import project_band as pb
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    monkeypatch.setenv("GA_REACH_MAXN", "0")
    d = LONGSIM if bw == 35 else FIX / "ont"
    graph = load_alignment_graph(str(LONGSIM / "graph.vg"))
    reads = load_fastq(str(d / "reads.fastq"))
    seeds = load_seed_hits(str(d / "seeds.gam"), [r.seq_id for r in reads])
    gold = {a.name: a for a in _gam(d / golden)}
    n0 = pb.LAUNCHES
    aligner = ba.BandedBatchAligner(graph, bw, ramp, cuda)
    assert aligner._dt.reach is None
    res = ba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    assert pb.LAUNCHES > n0
    for r in reads:
        a = res[r.seq_id]
        if a.alignment_failed or a.alignment.score == 2**31 - 1:
            assert r.seq_id not in gold
            continue
        mine = vg.Alignment.decode(a.alignment.encode())
        for m in mine.path.mapping:
            m.position.node_id //= 2
        assert mine == gold[r.seq_id]


@pytest.mark.cuda
@pytest.mark.parametrize("bw,ramp,golden", [(35, 0, "golden_b35"),
                                            (5, 20, "golden_b5_B20")])
def test_two_shard_mesh_on_one_card_matches_golden(cuda, bw, ramp, golden,
                                                   monkeypatch):
    """sim on a mesh of two shards on one card ([cuda:0, cuda:0]): every
    round split in two equal halves, each scanned and walked on its own,
    the goldens byte for byte with no host fallback."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.io import stream, vg
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import walk_moves as k2
    from graphaligner_tpu_torch.parallel import make_mesh

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    graph, reads, seeds = _sim()
    card = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(devices=[card, card])
    n1, n2 = k1.LAUNCHES, k2.LAUNCHES
    aligner = ba.BandedBatchAligner(graph, bw, ramp, mesh=mesh)
    res = ba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    assert k1.LAUNCHES > n1 and k2.LAUNCHES > n2
    assert min(aligner.shard_bytes) > 0
    gold = {a.name: a for a in
            stream.read_messages(str(SIM / golden / "out.gam"), vg.Alignment)}
    for r in reads:
        aln = vg.Alignment.decode(res[r.seq_id].alignment.encode())
        for m in aln.path.mapping:
            m.position.node_id //= 2
        assert aln == gold[r.seq_id]
