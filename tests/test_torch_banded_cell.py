"""K1's plain cell pass against graphaligner_tpu's banded_cell_kernel.

``banded_cell_plain`` is the cell pass that ``slice_cells_plain`` (the
plain version of the fused K1) runs. The JAX kernel runs in Pallas
interpret mode on the CPU. Two sources of arguments: every slice of a port
scan over sim reads (recorded at the cell pass's call site, so the
metadata is the production layout), and a
seeded random case that respects the meta bit layout but draws every
field — random column words included — freely. Tolerance zero: the
outputs are integer.

Past 5 in-neighbours the plain cell pass reads its predecessors from
``pred_words(K_in)`` planes; the Pallas kernel's one word holds five. The
random cases at K_in 6 and 8 keep at most five predecessors valid a cell,
and the kernel, at K_in 5, gets each cell's valid fields compacted into its
word in their order: it merges the valid predecessors in field order and
skips the others, so that is the same computation.
"""

import pathlib

import numpy as np
import pytest
import torch

from graphaligner_tpu_torch.ops.banded_cell import banded_cell_plain

SIM = pathlib.Path(__file__).parent / "fixtures" / "sim"


def _compact5(m2, K_in):
    """[P * Cm, B] pred planes -> the [Cm, B] word of each cell's valid
    fields (at most five) in field order, as the Pallas kernel takes it."""
    Cm = m2.shape[0] // -(-K_in // 5)
    planes = m2.astype(np.int64).reshape(-1, Cm, m2.shape[1])
    fields = np.stack([(planes[k // 5] >> (6 * (k % 5))) & 63
                       for k in range(K_in)])
    valid = (fields >> 5) & 1
    assert valid.sum(0).max() <= 5
    order = np.argsort(1 - valid, axis=0, kind="stable")[:5]
    kept = np.take_along_axis(fields * valid, order, axis=0)
    word = sum(kept[i] << (6 * i) for i in range(5))
    return word.astype(np.int32)


def _both(args, K_in):
    # jax is imported here, not at the top: test_torch_cuda.py imports
    # _random_args on the GPU machine, which has no jax
    import jax.numpy as jnp

    from graphaligner_tpu.ops.pallas.banded_cell import banded_cell_kernel

    B = args[0].shape[1]
    ref_args, ref_k = list(args), K_in
    if K_in > 5:
        ref_args[1], ref_k = _compact5(args[1], K_in), 5
    ref = banded_cell_kernel(*[jnp.asarray(a) for a in ref_args], K_in=ref_k,
                             Bb=B)
    got = banded_cell_plain(*[torch.from_numpy(np.ascontiguousarray(a))
                              for a in args], K_in=K_in)
    for name, r, g in zip(("cols", "buf", "nmin"), ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


def _random_args(rng, Cm, Nm, B, K_in):
    slot = rng.integers(0, Nm + 2, (Cm, B))  # some slots past Nm
    flags = rng.integers(0, 2, (6, Cm, B))
    code = rng.integers(0, 8, (Cm, B))  # codes 5-7 select no Eq word
    m1 = (slot | (flags[0] << 8) | (flags[1] << 9) | (flags[2] << 10)
          | (flags[3] << 11) | (code << 12) | (flags[4] << 15)
          | (flags[5] << 16))
    # pred planes of five 6-bit fields; past five, at most five valid a cell
    m2 = np.zeros((-(-K_in // 5), Cm, B), np.int64)
    n_valid = np.zeros((Cm, B), np.int64)
    for k in range(K_in):
        f = (rng.integers(0, 32, (Cm, B))
             | (rng.integers(0, 2, (Cm, B)) << 5))
        f = np.where(n_valid >= 5, f & 31, f)
        n_valid += f >> 5
        m2[k // 5] |= f << (6 * (k % 5))
    m2 = m2.reshape(-1, B)
    inf = 1 << 20
    old_end = np.where(rng.random((Cm, B)) < 0.2, inf,
                       rng.integers(0, 400, (Cm, B)))
    pseudo = np.where(rng.random((Cm, B)) < 0.5, inf,
                      rng.integers(0, 400, (Cm, B)))
    words = lambda *s: rng.integers(-2**31, 2**31, s)
    eq_lo, eq_hi = words(5, B), words(5, B)
    seq_len = rng.integers(64, 2000, (1, B))
    buf = np.concatenate([
        words(4, Nm, B),
        rng.integers(0, 500, (1, Nm, B)),
        rng.integers(0, 560, (1, Nm, B)),
        rng.integers(0, 16, (1, Nm, B)),
    ])
    return [np.asarray(a, dtype=np.int32) for a in
            (m1, m2, old_end, pseudo, eq_lo, eq_hi, seq_len, buf)]


def _random_slice_args(rng, N, K_in, Nm, Cm, B):
    """Seeded arguments of ``slice_cells`` on a random graph of in-degree up
    to ``K_in`` (back edges included): bands and previous bands that share
    nodes, scores with INF holes, some lanes inactive, Eq windows past both
    ends of the read. numpy arrays in the wrapper's dtypes."""
    from graphaligner_tpu_torch.core.tables import _MATCH_TABLE, match_bits

    empty, inf = 2**31 - 1, 1 << 20
    node_len = rng.integers(1, 14, N)
    node_start = np.cumsum(node_len) - node_len
    in_nbrs = np.full((N, K_in), -1)
    for n in range(N):
        deg = int(rng.integers(0, K_in + 1))
        in_nbrs[n, :deg] = rng.choice(N, deg, replace=False)
    seq_codes = rng.integers(0, 5, int(node_len.sum()))

    def band():
        out = np.full((Nm, B), empty)
        for b in range(B):
            k = int(rng.integers(0, Nm + 1))
            out[:k, b] = np.sort(rng.choice(N, k, replace=False))
        return out

    def scores(shape, hi, p_inf):
        return np.where(rng.random(shape) < p_inf, inf,
                        rng.integers(0, hi, shape))

    L = 4 * 64
    args = (
        band(), rng.random(B) < 0.1, band(),
        scores((Nm, B), 300, 0.2), scores((Nm, B), 300, 0.2),
        scores((Cm, B), 400, 0.2), rng.integers(0, 100, B),
        rng.random(B) < 0.8, rng.random(B) < 0.3, rng.integers(64, 2000, B),
        rng.integers(0, 15, (B, L)), rng.integers(0, 6, B),
        node_len, node_start, in_nbrs, seq_codes, match_bits(_MATCH_TABLE),
    )
    dtypes = [np.int32, bool, np.int32, np.int32, np.int32, np.int32,
              np.int32, bool, bool, np.int32, np.uint8] + [np.int32] * 6
    return [np.ascontiguousarray(a, dtype=d) for a, d in zip(args, dtypes)]


def test_slice_cells_random_in_degree_5_cpu_route(monkeypatch):
    """CPU tensors take the plain version; its outputs hold the invariants
    of the step: inactive lanes keep their carries and a zero control word,
    every cell past the band is the invalid column."""
    import graphaligner_tpu_torch.ops.banded_cell as k1

    calls = []
    orig = k1.slice_cells_plain
    monkeypatch.setattr(k1, "slice_cells_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    Nm, Cm, B = 32, 160, 24
    args = [torch.from_numpy(a) for a in
            _random_slice_args(np.random.default_rng(5), 60, 5, Nm, Cm, B)]
    n0 = k1.LAUNCHES
    cols, nm, ctrl, ids, send, nmin, nend, pmin = k1.slice_cells(*args)
    assert calls == [1] and k1.LAUNCHES == n0
    assert cols.shape == (7, Cm, B) and nm.shape == (6, Nm, B)
    idle = ~args[7]
    assert idle.any() and (ctrl[idle] == 0).all()
    for new, old in ((ids, args[2]), (send, args[5]), (nmin, args[3]),
                     (nend, args[4]), (pmin, args[6])):
        assert torch.equal(new[..., idle], old[..., idle])
    c_used = (ctrl >> 7) & 0x7FFFFF
    assert ((ctrl >> 30) & 1).bool().any()  # some band overflows Cm
    for b in torch.nonzero(args[7]).flatten().tolist():
        tail = cols[:, int(c_used[b]):, b]
        assert (tail[4] == 1 << 20).all() and (tail[6] == 8).all()


@pytest.mark.parametrize("seed,K_in", [(0, 2), (1, 3), (2, 5), (3, 6),
                                        (4, 8)])
def test_banded_cell_plain_matches_jax_random(seed, K_in):
    rng = np.random.default_rng(seed)
    _both(_random_args(rng, Cm=40, Nm=16, B=32, K_in=K_in), K_in)


def test_banded_cell_plain_matches_jax_on_recorded_sim_slices(monkeypatch):
    """Every cell pass of a port scan over sim reads, replayed through
    both."""
    import graphaligner_tpu_torch.core.engine_banded as eb
    import graphaligner_tpu_torch.ops.banded_cell as k1
    from graphaligner_tpu.core.align import _pad_to_word
    from graphaligner_tpu.core.params import WORD_SIZE
    from graphaligner_tpu.core.reach import ensure_reach
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq
    from graphaligner_tpu.runtime.aligner import load_seed_hits
    from graphaligner_tpu_torch.core.engine import encode_read
    from graphaligner_tpu_torch.core.tables import (
        build_graph_tables, device_tables, make_seed_carry,
    )

    calls = []
    orig = k1.banded_cell_plain

    def rec(*args, **kw):
        calls.append(([a.numpy().copy() for a in args], kw["K_in"]))
        return orig(*args, **kw)

    monkeypatch.setattr(k1, "banded_cell_plain", rec)
    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))[:4]
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    tables = build_graph_tables(graph)
    reach = ensure_reach(tables, 35 + WORD_SIZE - 1)
    probs = []
    for r in reads:
        node_id, pos, rev = seeds[r.seq_id][0]
        probs.append((_pad_to_word(r.sequence[pos:]),
                      graph.node_lookup[node_id * 2 + (1 if rev else 0)]))
    B, Nm, Cm = 16, 32, 288
    S = max(len(p[0]) // WORD_SIZE for p in probs)
    codes = np.full((B, S * WORD_SIZE), 14, np.uint8)
    seq_len = np.zeros(B, np.int32)
    steps = np.zeros(B, np.int32)
    starts = np.zeros(B, np.int32)
    for i, (seq, node) in enumerate(probs):
        codes[i, : len(seq)] = encode_read(seq)
        seq_len[i], steps[i], starts[i] = len(seq), len(seq) // 64, node
    eb.banded_scan(
        device_tables(tables, reach, "cpu"), codes, seq_len, steps,
        np.zeros(B, np.int32), np.full((S, B), 35, np.int32),
        *make_seed_carry(tables, starts, Nm, Cm), S_max=S, Nm=Nm, Cm=Cm,
    )
    assert len(calls) >= S
    for args, K_in in calls[:: max(1, len(calls) // 3)]:
        _both(args, K_in)


def test_banded_cell_checks_its_arguments():
    args = [torch.from_numpy(a) for a in
            _random_args(np.random.default_rng(0), 8, 4, 8, 2)]
    with pytest.raises(ValueError, match="old_end"):
        banded_cell_plain(*args[:2], args[2].long(), *args[3:], K_in=2)
    with pytest.raises(ValueError, match="meta2"):  # K_in 6: two planes
        banded_cell_plain(*args, K_in=6)
    with pytest.raises(ValueError, match="meta2"):  # K_in 33: seven planes
        banded_cell_plain(*args, K_in=33)
    with pytest.raises(NotImplementedError, match="predecessor column"):
        banded_cell_plain(*args, K_in=0)
    wide = [torch.from_numpy(a) for a in
            _random_args(np.random.default_rng(1), 8, 4, 8, 70)]
    banded_cell_plain(*wide, K_in=70)  # no in-degree gate: 14 planes
