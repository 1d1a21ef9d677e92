"""The port on graphs of in-degree past 32 against the JAX package.

Past 32 in-neighbours K1's wide route keeps more pred planes (one per five
in-neighbours), K2's weighs the in-neighbours a chunk of 32 at a time, and
past 64 its move codes take 16 bits. The JAX package runs its XLA cell pass
(``cell_pass_xla``) and its XLA walk (``walk_batch``) there, at any
in-degree. The port's plain versions run here. Tolerance zero: every
output is integer.

- ``banded_scan``, and so ``slice_cells_plain`` on every slice, against
  the JAX scan on seeded graphs of two converging trees of 33, 64 and 70
  leaves (in-degree 33, 64, 70: one past each boundary of 32 and 64), from
  random carries around the joining segment, with a back edge, so the
  fixpoint runs; the pred planes hold in-neighbours past 32 (and 64);
- the plain wide walk, decoded by the native decoder, against walk_batch
  on the same tables at in-degree 33 (byte codes) and 70 (16-bit codes):
  traces and fail flags at walk_batch's budget and at one the longest
  lane cannot meet, with moves through in-neighbours past 32 (and 64);
- the whole slice, ``align_reads_seeded_batch``, on the small converging
  corpus (tests/fixtures/torch/converging_small: trees of 33 to 70 leaves
  and one flat site of 33 short alleles) against the JAX package's goldens
  at -b 35 and -b 5 -B 20: byte for byte, and the reads sent to the host
  oracle (a lane across the flat site holds 34 band nodes, past 32) are
  the JAX package's.

The JAX package's scan and walk outputs are stored, with their inputs, in
tests/fixtures/torch/in_degree_wide/ (``make_goldens.py in_degree_wide``):
its XLA cell pass and walk unroll a Python loop over the in-degree, and
XLA takes minutes to compile them on the CPU (a scan of 3 slices of 8
lanes: 201.5 s of CPU at in-degree 33, 519.5 s at 70; README.md there).
Each file holds the graph and the exact arguments both packages took.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from test_torch_in_degree import PRED_MASK

HERE = pathlib.Path(__file__).resolve().parent
FIX = HERE / "fixtures" / "torch"
UNITS = FIX / "in_degree_wide"
SMALL = FIX / "converging_small"
SCAN_K = (33, 64, 70)
WALK_K = (33, 70)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions issue many small ops: one intra-op thread a
    worker keeps them from oversubscribing the CPU the workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(name, tmp_path):
    """A stored unit: its arrays, and the port's graph and tables of its
    GFA."""
    from graphaligner_tpu_torch.core.tables import build_graph_tables
    from graphaligner_tpu_torch.graph import graph_from_gfa_file

    z = dict(np.load(UNITS / f"{name}.npz"))
    path = tmp_path / "g.gfa"
    path.write_text(str(z.pop("gfa")))
    graph = graph_from_gfa_file(str(path))
    return z, graph, build_graph_tables(graph)


def _valid_ks(planes, Nm):
    """The in-neighbour indices with a valid field anywhere in a [S, P *
    Nm, B] pred table."""
    ks = set()
    for p in range(planes.shape[1] // Nm):
        plane = planes[:, p * Nm:(p + 1) * Nm]
        for f in range(5):
            if ((plane >> (6 * f + 5)) & 1).any():
                ks.add(5 * p + f)
    return ks


@pytest.mark.parametrize("K", SCAN_K)
def test_slice_cells_plain_matches_xla_cell_pass_past_32(K, tmp_path,
                                                         monkeypatch):
    """The port's scan from random carries on a graph of in-degree K,
    every slice through slice_cells_plain, against the JAX scan (its cell
    pass cell_pass_xla); the back edge makes some lane take more than one
    cell pass, and the pred planes hold in-neighbours past 32 (past 64 at
    70). Both packages project the same way: through a reach table where
    ensure_reach builds one, else iteratively."""
    import graphaligner_tpu_torch.ops.banded_cell as k1
    from graphaligner_tpu_torch.core.engine_banded import banded_scan
    from graphaligner_tpu_torch.core.reach import ensure_reach
    from graphaligner_tpu_torch.core.tables import device_tables

    z, graph, tables = _unit(f"scan{K}", tmp_path)
    assert tables.k_in == K == int(z["k_in"])
    reach = ensure_reach(tables, 35 + 63)
    assert (reach is not None) == bool(z["reach"])
    S_max, Nm, Cm = (int(x) for x in z["shape"])
    passes = []
    orig_slice, orig_cell = k1.slice_cells_plain, k1.banded_cell_plain

    def count_slice(*a, **kw):
        passes.append(0)
        return orig_slice(*a, **kw)

    def count_cell(*a, **kw):
        passes[-1] += 1
        return orig_cell(*a, **kw)

    monkeypatch.setattr(k1, "slice_cells_plain", count_slice)
    monkeypatch.setattr(k1, "banded_cell_plain", count_cell)
    got = banded_scan(device_tables(tables, reach, "cpu"),
                      *[z[f"a{i}"] for i in range(10)], S_max=S_max, Nm=Nm,
                      Cm=Cm)
    assert len(passes) == S_max and max(passes) > 1
    ref = {k[4:]: v for k, v in z.items() if k.startswith("jax_")}
    assert set(got) == set(ref)
    for key in sorted(got):
        have, want = got[key].numpy(), ref[key]
        if key in ("pred_tab", "pred_prev"):
            assert have.shape[1] == -(-K // 5) * Nm, key
            have, want = have[:, :Nm] & PRED_MASK, want & PRED_MASK
        assert have.dtype == want.dtype, key
        np.testing.assert_array_equal(have, want, err_msg=key)
    ks = _valid_ks(got["pred_tab"].numpy(), Nm)
    assert max(ks) >= (64 if K > 64 else 32)


def _jax_traces(trace, fail):
    """walk_batch's per-lane forward traces after _walk_xla's post-check
    (None for a failed lane)."""
    out = []
    for b in range(trace.shape[2]):
        rows = trace[:, 1, b]
        n = int(np.argmax(rows == -2)) if (rows == -2).any() else len(rows)
        arr = np.stack([trace[:n, 0, b], rows[:n]], axis=1).astype(np.int64)
        if fail[b] or len(arr) < 2 or arr[-1, 1] != -1 or arr[-2, 1] != 0:
            out.append(None)
        else:
            out.append(arr[-2::-1])
    return out


@pytest.mark.parametrize("K", WALK_K)
def test_plain_wide_walk_matches_walk_batch_past_32(K, tmp_path):
    """The plain wide walk (Bb=1) and the native decoder against
    walk_batch on the same tables, those of the largest K2 call of the
    port's aligner on reads through converging trees of K leaves: every
    lane's trace and fail flag at walk_batch's budget (the call's; every
    lane walks) and at one the longest lane cannot meet (it fails in both,
    shorter lanes walk). Byte codes at 33, 16-bit codes at 70; moves
    through in-neighbours past 32 (past 64 at 70), so through K2's second
    (third) chunk. The stored tables are lane-last; the wide route takes
    them lane-major (lane_major_tables)."""
    from graphaligner_tpu_torch.io import native
    from graphaligner_tpu_torch.ops import walk_moves as k2

    z, graph, tables = _unit(f"walk{K}", tmp_path)
    assert tables.k_in == K == int(z["k_in"])
    args = [torch.from_numpy(z[f"a{i}"]) for i in range(11)]
    args[:6] = k2.lane_major_tables(args[:6])
    keeps = z["a10"][0].astype(np.int64)
    B = len(keeps)
    bits = k2.code_bits(K)
    assert bits == (8 if K <= 64 else 16)
    h0, d0 = k2.move_bases(K)
    ks = set()
    for i, T in enumerate(int(t) for t in z["budgets"]):
        n0 = k2.LAUNCHES + k2.LAUNCHES_WIDE
        moves, fail, _, used = k2.walk_moves(*args, K_in=K, steps=T,
                                             W_cap=T)
        assert k2.LAUNCHES + k2.LAUNCHES_WIDE == n0  # the plain version
        assert moves.shape[0] == -(-(T + 1) // (32 // bits))
        m = moves.numpy().view(np.uint32).astype(np.int64)
        for j in range(32 // bits):
            c = (m >> (bits * j)) & ((1 << bits) - 1)
            ks |= {int(x - base) for base in (h0, d0)
                   for x in np.unique(c[(c >= base) & (c < base + h0)])}
        w, r, n = native.decode_moves_batch(
            moves.numpy().view(np.uint32), np.arange(B, dtype=np.int32),
            z["w0"].astype(np.int64), keeps * 64 - 1,
            np.ascontiguousarray(tables.node_start, dtype=np.int64),
            np.ascontiguousarray(tables.node_end, dtype=np.int64),
            np.ascontiguousarray(tables.pos_to_node),
            np.ascontiguousarray(tables.in_nbrs), T + 1, 1, code_bits=bits)
        want = _jax_traces(z[f"jax_trace{i}"], z[f"jax_fail{i}"])
        for b in range(B):
            ok = not fail[0, b] and n[b] >= 1 and r[b, 0] == 0
            assert ok == (want[b] is not None), (T, b)
            if ok:
                got = np.stack([w[b, : n[b]], r[b, : n[b]]], axis=1)
                np.testing.assert_array_equal(got, want[b])
        if i == 0:
            assert all(x is not None for x in want)
        else:
            lost = [b for b in range(B) if want[b] is None]
            assert lost and int(np.argmax(keeps)) in lost and len(lost) < B
    assert max(ks) >= (64 if K > 64 else 32)


@pytest.mark.parametrize("bw,ramp,tag", [(35, 0, "b35"), (5, 20, "b5_B20")])
def test_slice_matches_jax_golden_on_the_small_converging_corpus(
        bw, ramp, tag, monkeypatch):
    """align_reads_seeded_batch on the small converging corpus (in-degree
    70) byte for byte against the JAX package's golden, through both wide
    routes' plain versions; the reads that cross the flat site of 33
    alleles go to the host oracle, as they do in the JAX package (the
    golden's host list), and no other read does."""
    from graphaligner_tpu_torch.core import align as host
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.graph import graph_from_gfa_file
    from graphaligner_tpu_torch.io import load_fastq, stream, vg
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import walk_moves as k2
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits

    graph = graph_from_gfa_file(str(SMALL / "graph.gfa"))
    reads = load_fastq(str(SMALL / "reads.fastq"))
    seeds = load_seed_hits(str(SMALL / "seeds.gam"),
                           [r.seq_id for r in reads])
    calls = {"k1": 0, "k2": 0}
    sent = []
    orig1, orig2 = k1.slice_cells_plain, k2.walk_moves_plain
    orig_host = host.get_split_alignment
    by_seq = {r.sequence: r.seq_id for r in reads}

    def c1(*a, **kw):
        calls["k1"] += 1
        return orig1(*a, **kw)

    def c2(*a, **kw):
        calls["k2"] += 1
        assert kw["K_in"] == 70 and kw["Bb"] == 1
        return orig2(*a, **kw)

    def split(graph_, sequence, *a, **kw):
        sent.append(by_seq[sequence])
        return orig_host(graph_, sequence, *a, **kw)

    monkeypatch.setattr(k1, "slice_cells_plain", c1)
    monkeypatch.setattr(k2, "walk_moves_plain", c2)
    monkeypatch.setattr(host, "get_split_alignment", split)
    aligner = ba.BandedBatchAligner(graph, bw, ramp, "cpu")
    assert aligner.tables.k_in == 70
    fb0 = ba.host_fallback_count()
    res = ba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    assert calls["k1"] and calls["k2"]
    jax_host = (SMALL / f"out_{tag}_host.txt").read_text().split()
    assert sorted(set(sent)) == jax_host
    assert ba.host_fallback_count() - fb0 == len(sent) > 0
    assert len(jax_host) < len(reads)
    mine = []
    for r in reads:
        aln = vg.Alignment.decode(res[r.seq_id].alignment.encode())
        for m in aln.path.mapping:
            m.position.node_id //= 2
        mine.append(aln.encode())
    want = [a.encode() for a in
            stream.read_messages(str(SMALL / f"out_{tag}.gam"), vg.Alignment)]
    assert mine == want
