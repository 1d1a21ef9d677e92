"""K2's plain version against graphaligner_tpu's walk_moves kernel.

The arguments are recorded from the JAX production walk on sim (the
Pallas kernel in interpret mode, GA_FORCE_PALLAS=1 GA_FORCE_MOVES=1), then
replayed through both. The port's plain version keeps the lockstep
semantics, so raw moves, fail flags, state and ``used`` must all be
identical (tolerance zero). A second case perturbs the starts so some lanes
fail, and one caps the per-slice budget so lanes get stuck. The tests of
the per-lane semantics (Bb=1, the CUDA kernel's) and of window chains
follow below.
"""

import pathlib

import numpy as np
import pytest
import torch

import graphaligner_tpu.ops.pallas.walk_moves as jwm
from graphaligner_tpu.core.batch_align import (
    BandedBatchAligner,
    align_reads_seeded_batch,
)
from graphaligner_tpu.graph import load_alignment_graph
from graphaligner_tpu.io import load_fastq
from graphaligner_tpu.runtime.aligner import load_seed_hits
from graphaligner_tpu_torch.ops.walk_moves import walk_moves, walk_moves_plain
from test_torch_cuda import _assert_traces_equal, _decode

SIM = pathlib.Path(__file__).parent / "fixtures" / "sim"


@pytest.fixture(scope="module")
def recorded():
    """(args, kwargs) of every JAX walk_moves call on 6 sim reads."""
    calls = []
    orig = jwm.walk_moves

    def rec(*args, **kw):
        calls.append(([np.asarray(a) for a in args], dict(kw)))
        return orig(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setenv("GA_FORCE_PALLAS", "1")
    mp.setenv("GA_FORCE_MOVES", "1")
    mp.setattr(jwm, "walk_moves", rec)
    try:
        graph = load_alignment_graph(str(SIM / "bubbles.vg"))
        reads = load_fastq(str(SIM / "sim.fastq"))[:6]
        seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
        align_reads_seeded_batch(graph, BandedBatchAligner(graph, 35, 0),
                                 reads, seeds)
    finally:
        mp.undo()
    assert calls
    return calls


def _both(args, W_cap=448, **kw):
    ref = jwm.walk_moves(*args, W_cap=W_cap, **kw)
    got = walk_moves(*[torch.from_numpy(np.array(a))
                       for a in args], W_cap=W_cap, **kw)
    for name, r, g in zip(("moves", "fail", "state_out", "used"), ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    return got


def test_walk_moves_plain_matches_jax(recorded):
    for args, kw in recorded:
        moves, fail, _, used = _both(args, **kw)
        assert int(used.max()) > 0
        assert not fail[0, : int((args[10][5] == 0).sum())].all()


def test_walk_moves_plain_matches_jax_on_failing_lanes(recorded):
    args, kw = recorded[0]
    args = [a.copy() for a in args]
    st = args[10]
    live = np.nonzero(st[5] == 0)[0]
    st[4, live[::2]] += 3  # wrong start scores: no predecessor fits
    _, fail, _, _ = _both(args, **kw)
    assert fail[0, live[::2]].any()


def test_walk_moves_plain_matches_jax_with_tight_budget(recorded):
    args, kw = recorded[0]
    _, fail, _, _ = _both(args, W_cap=20, **kw)
    assert fail.any()


def test_walk_moves_refuses_wide_in_degree(recorded):
    """The wide route's limit is shared memory, and its shared bytes no
    longer grow with the in-degree (its pred planes are read into
    node-start lists, not staged): at in-degree 33 the call's one-plane
    pred tables are refused for their shape (it takes seven), and past the
    16-bit codes' 16,384 for the code width; a slice's tables at any
    in-degree take what they take at 5; its two slice buffers fit the top
    capacity tier (Cm=2304); only a Cm past any tier makes them pass a
    block, and the launch raises, naming the in-degree, Cm, Nm and
    bytes."""
    from graphaligner_tpu_torch.ops import walk_moves as k2

    args, kw = recorded[0]
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    major = [*k2.lane_major_tables(tensors[:6]), *tensors[6:]]
    with pytest.raises(ValueError, match="pred_tab"):
        walk_moves(*major, K_in=33)
    with pytest.raises(ValueError, match="16-bit move codes"):
        walk_moves(*major, K_in=k2.WIDEST_K_IN + 1)
    R = tensors[6].shape[0]
    for K_in in (33, 200, k2.WIDEST_K_IN):
        assert k2.smem_bytes(2304, 32, R, K_in) == k2.smem_bytes(
            2304, 32, R, 5)
    assert k2.smem_bytes(2304, 32, R, 80) <= k2.SMEM_LIMIT
    Cm = 2304
    while k2.smem_bytes(Cm, 32, R, 80) <= k2.SMEM_LIMIT:
        Cm += 64
    need = k2.smem_bytes(Cm, 32, R, 80)
    z = torch.zeros
    small = [z((2, 1, 7, Cm), dtype=torch.int32)] + [
        z((2, 1, n), dtype=torch.int32) for n in (32, 32, 16 * 32, 16 * 32)
    ] + [z((2, 1, 64), dtype=torch.uint8), tensors[6]] + [
        z((1, 1), dtype=torch.int32)] * 3 + [z((16, 1), dtype=torch.int32)]
    with pytest.raises(NotImplementedError,
                       match=f"in-degree 80, Cm={Cm}, Nm=32 take {need} "
                             "bytes"):
        k2._launch(*small, K_in=80, W_cap=448, steps=100)


def _codes(moves, per, n):
    """The first n move codes of each lane of a [T_w, B] int32 stream of
    ``per`` codes a word: [n, B]."""
    m = moves.to(torch.int64) & 0xFFFFFFFF
    bits = 32 // per
    shift = bits * torch.arange(per)
    c = (m[:, None, :] >> shift[None, :, None]) & ((1 << bits) - 1)
    return c.reshape(-1, m.shape[1])[:n]


def test_walk_moves_lane_major_tables(recorded):
    """The layout is the route's: lane_major_tables and lane_last_tables
    invert each other and table_dims reads each route's layout. A narrow
    call's tables, made lane-major and walked at in-degree 5 (the wide
    route, byte codes; no table holds an in-neighbour 4), walk as the
    narrow route walks them lane-last at Bb=1: the same fail flags, state
    and used, and the same moves once each nibble code is recoded as its
    byte code."""
    from graphaligner_tpu_torch.ops import walk_moves as k2

    args, kw = recorded[0]
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    major = k2.lane_major_tables(tensors[:6])
    K1, _, Cm, B = tensors[0].shape
    assert major[0].shape == (K1, B, 7, Cm) and major[0].is_contiguous()
    for a, b in zip(k2.lane_last_tables(major), tensors[:6]):
        assert torch.equal(a, b)
    K_in = kw["K_in"]
    assert K_in <= k2.NIBBLE_K_IN and not k2.lane_major(K_in)
    assert k2.lane_major(k2.NIBBLE_K_IN + 1)
    dims = k2.table_dims(tensors, K_in)
    assert dims == k2.table_dims(major, 5) == (K1 - 1, Cm,
                                               tensors[1].shape[1], B)
    rest = {k: v for k, v in kw.items() if k != "K_in"}
    want = walk_moves_plain(*tensors, K_in=K_in, Bb=1, **rest)
    got = walk_moves(*major, *tensors[6:], K_in=5, **rest)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    n = int(want[3].max()) + 1
    nib = _codes(want[0], 8, n)
    recoded = torch.where(nib >= 12, nib - 12 + 128,
                          torch.where(nib >= 8, nib - 8 + 64, nib))
    assert torch.equal(_codes(got[0], 4, n), recoded)
    assert (nib >= 8).any()  # moves through in-neighbours


# ---------------------------------------------------------------- per lane
# The CUDA kernel steps each lane on its own budget; walk_moves_plain at
# Bb=1 has those semantics. The tests below pin them on the CPU: against
# the JAX kernel at block width 1, against the lockstep widths through the
# native decoder, and across a window chain (win_base, init_state and
# state_out, as a windowed long-read walk chains calls).


def _lanes(args, idx):
    """The recorded call cut to lanes ``idx`` (every array is lane-last
    except bits_lut)."""
    return [a if i == 6 else np.ascontiguousarray(a[..., idx])
            for i, a in enumerate(args)]


def _live(args):
    return np.nonzero(args[10][5] == 0)[0]


def _plain(args, **kw):
    return [o.numpy() for o in walk_moves_plain(
        *[torch.from_numpy(np.array(a)) for a in args], **kw)]


def _jax(args, **kw):
    return [np.asarray(o) for o in jwm.walk_moves(*args, **kw)]


@pytest.fixture(scope="module")
def sim_graph():
    from graphaligner_tpu_torch.graph import load_alignment_graph as load_port

    return load_port(str(SIM / "bubbles.vg"))


def test_walk_moves_plain_per_lane_matches_jax(recorded):
    """Plain at Bb=1 equals the JAX kernel at Bb=1 (interpret mode) in all
    four outputs, on four live lanes of the first recorded call and with
    a budget cut so lanes stop mid-walk."""
    args, kw = recorded[0]
    sub = _lanes(args, _live(args)[:4])
    for W_cap in (448, 20):
        want = _jax(sub, **dict(kw, W_cap=W_cap, Bb=1))
        got = _plain(sub, **dict(kw, W_cap=W_cap, Bb=1))
        for name, r, g in zip(("moves", "fail", "state_out", "used"), want,
                              got):
            np.testing.assert_array_equal(g, r, err_msg=f"{name} W_cap={W_cap}")


def test_walk_moves_plain_block_widths_decode_alike(recorded, sim_graph):
    """On every recorded call, plain at Bb=1 (per lane) and at the default
    width (lockstep, PAD while the block steps) give the same fail flags,
    and every live lane decodes to the same trace."""
    for args, kw in recorded:
        lock = _plain(args, **kw)
        lane = _plain(args, **kw, Bb=1)
        np.testing.assert_array_equal(lane[1], lock[1])
        assert (lane[3] <= lock[3]).all()
        ok = _live(args)[lock[1][0, _live(args)] == 0]
        assert len(ok)
        _assert_traces_equal(_decode(sim_graph, args, lock[0], lock[3], ok),
                             _decode(sim_graph, args, lane[0], lane[3], ok))


@pytest.mark.parametrize("Bb", [1, 256])
def test_walk_moves_window_chain(recorded, sim_graph, Bb):
    """The first recorded call's table split at a middle slice m: the
    upper window (slices m+1..K, win_base m, entry 0 = slice m) walked
    from the call's state, then the lower one (slices 1..m) from the upper
    window's state_out. Plain equals JAX in each window, every lane leaves
    the upper window below it or not yet started, and the two move streams
    concatenated decode as the single-window walk does."""
    args, kw = recorded[0]
    live = _live(args)
    sk = args[10][0, live]
    # lanes that start above m, and two that start below it (they pass the
    # upper window untouched)
    m = int(sk[sk >= 4].min()) // 2
    args = _lanes(args, np.concatenate([live[sk > m][:6], live[sk <= m][:2]]))
    sk = args[10][0]
    assert m >= 1 and (sk <= m).sum() == 2
    upper = [a[m:] if i < 6 else a for i, a in enumerate(args)]
    upper[9] = np.full_like(args[9], m)
    outs = []
    for win in (upper, None):
        if win is None:
            win = [a[: m + 1] if i < 6 else a for i, a in enumerate(args)]
            win[10] = outs[0][2]
        win = [np.ascontiguousarray(a) for a in win]
        want = _jax(win, **kw, Bb=Bb)
        got = _plain(win, **kw, Bb=Bb)
        for name, r, g in zip(("moves", "fail", "state_out", "used"), want,
                              got):
            np.testing.assert_array_equal(g, r, err_msg=name)
        outs.append(got)
    assert not outs[0][1].any() and (outs[0][2][0] <= m).all()
    assert not outs[1][1].any() and (outs[1][2][5] == 1).all()
    whole = _plain(args, **kw, Bb=Bb)
    chained = np.concatenate([outs[0][0], outs[1][0]])
    lanes = np.arange(len(sk))
    _assert_traces_equal(
        _decode(sim_graph, args, whole[0], whole[3], lanes),
        _decode(sim_graph, args, chained, [chained.shape[0] * 8 - 1], lanes),
    )
