"""K3's plain version against graphaligner_tpu's exhaustive-mode DP.

``exhaustive_plain`` must give the six slabs of
``ops.pallas.exhaustive.make_kernel`` (run through the Pallas interpreter:
``pallas_call`` is wrapped with ``interpret=True`` from outside the
package) and of ``core.engine._align_batch_device``, the XLA column engine
whose cyclic fixpoint the port carries. Inputs are random reads drawn from
a numpy seed; tolerance zero (everything is integer).
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from graphaligner_tpu.core.engine import (
    _MATCH_TABLE,
    _READ_CODE,
    _align_batch_device,
    build_schedule,
)
from graphaligner_tpu.graph import load_alignment_graph
from graphaligner_tpu_torch.core.engine import _build_eq_vectors
from graphaligner_tpu_torch.ops import exhaustive as k3

FIX = pathlib.Path(__file__).parent / "fixtures"
NAMES = ("vp_lo", "vp_hi", "vn_lo", "vn_hi", "sbs", "send")
CIRCLE = "circle of sim/bubbles.vg"  # written by make_goldens.write_circle_gfa


@functools.lru_cache(maxsize=None)
def _circle_gfa(tmp_dir: str) -> str:
    """sim/bubbles.vg closed into a circle (its two sinks linked to its
    source), as make_goldens.py closes the longsim graph."""
    spec = importlib.util.spec_from_file_location(
        "make_goldens", FIX / "torch" / "make_goldens.py")
    mg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mg)
    path = str(pathlib.Path(tmp_dir) / "bubbles_circle.gfa")
    mg.write_circle_gfa(str(FIX / "sim" / "bubbles.vg"), path)
    return path


@pytest.fixture(scope="module")
def cyclic_graphs(tmp_path_factory):
    """Cyclic graph files by name: the fixtures' and the small circle."""
    return {
        "sim/cyclic.gfa": str(FIX / "sim" / "cyclic.gfa"),
        "torch/circular_i/graph.gfa": str(FIX / "torch" / "circular_i"
                                          / "graph.gfa"),
        CIRCLE: _circle_gfa(str(tmp_path_factory.mktemp("circle"))),
    }


def _codes(seed, B, S):
    rng = np.random.default_rng(seed)
    codes = np.full((B, S * 64), _READ_CODE["N"], dtype=np.uint8)
    for i in range(B):
        n = int(rng.integers(10, S * 64))
        codes[i, :n] = rng.integers(0, len(_READ_CODE), n)
    return codes


def _plain(sched, codes, S):
    eq = _build_eq_vectors(codes, _MATCH_TABLE, S).view(np.int32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32))

    return k3.exhaustive(
        torch.as_tensor(eq), t(sched.code), t(sched.is_start),
        t(sched.is_source_start), t(sched.pred_nodes), t(sched.node_slot),
        num_nodes=sched.num_nodes, cyclic=sched.cyclic,
    )


def _assert_equal(got, want):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w, err_msg=name)


@pytest.mark.parametrize("graph,B,S", [("smallexample/sub_test.vg", 8, 2),
                                       ("sim/bubbles.vg", 4, 3)])
def test_plain_matches_pallas_kernel_interpret(graph, B, S, monkeypatch):
    import jax.experimental.pallas as pl

    from graphaligner_tpu.ops.pallas import exhaustive as jk3

    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    jk3._cached_kernel.cache_clear()
    try:
        sched = build_schedule(load_alignment_graph(str(FIX / graph)))
        codes = _codes(B * S, B, S)
        want = jk3.align_exhaustive_pallas(sched, codes, S, _MATCH_TABLE)
    finally:
        jk3._cached_kernel.cache_clear()
    *got, nonconv = _plain(sched, codes, S)
    assert not bool(nonconv.any())
    _assert_equal(got, want)


def test_plain_matches_column_engine_fixpoint_on_cyclic_graph():
    import jax.numpy as jnp

    from graphaligner_tpu.graph import graph_from_gfa_file

    sched = build_schedule(graph_from_gfa_file(str(FIX / "sim" / "cyclic.gfa")))
    assert sched.cyclic
    B, S = 4, 3
    codes = _codes(7, B, S)
    *want, nonconv = _align_batch_device(
        jnp.asarray(codes), jnp.asarray(sched.code),
        jnp.asarray(sched.is_start), jnp.asarray(sched.is_source_start),
        jnp.asarray(sched.pred_nodes), jnp.asarray(sched.node_slot),
        num_slices=S, num_nodes=sched.num_nodes, cyclic=True,
    )
    assert not bool(nonconv)
    *got, flags = _plain(sched, codes, S)
    assert not bool(flags.any())
    _assert_equal(got, want)


def test_plain_matches_column_engine_fixpoint_on_circle(cyclic_graphs):
    """The circle (sim/bubbles.vg closed from its sinks to its source; its
    reverse strand's schedule runs against every edge, so a slice takes
    many passes) at B=4, S=3: the plain version's slabs and flags equal the
    column engine's."""
    import jax.numpy as jnp

    from graphaligner_tpu.graph import graph_from_gfa_file

    sched = build_schedule(graph_from_gfa_file(cyclic_graphs[CIRCLE]))
    assert sched.cyclic
    B, S = 4, 3
    codes = _codes(12, B, S)
    *want, nonconv = _align_batch_device(
        jnp.asarray(codes), jnp.asarray(sched.code),
        jnp.asarray(sched.is_start), jnp.asarray(sched.is_source_start),
        jnp.asarray(sched.pred_nodes), jnp.asarray(sched.node_slot),
        num_slices=S, num_nodes=sched.num_nodes, cyclic=True,
    )
    assert not bool(nonconv)
    *got, flags = _plain_traced(cyclic_graphs[CIRCLE], 128)[0]
    assert not bool(flags.any())
    _assert_equal(got, want)


@functools.lru_cache(maxsize=None)
def _plain_traced(graph_file: str, max_passes: int):
    """The plain version's outputs and pass trace at B=4, S=3 (numpy seed
    12), with the port's schedule of ``graph_file``."""
    from graphaligner_tpu_torch.core.engine import build_schedule as tsched
    from graphaligner_tpu_torch.graph import load_alignment_graph as load

    sched = tsched(load(graph_file))
    B, S = 4, 3
    eq = _build_eq_vectors(_codes(12, B, S), _MATCH_TABLE, S).view(np.int32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32))

    trace = []
    out = k3.exhaustive_plain(
        torch.as_tensor(eq), t(sched.code), t(sched.is_start),
        t(sched.is_source_start), t(sched.pred_nodes), t(sched.node_slot),
        num_nodes=sched.num_nodes, cyclic=True, max_passes=max_passes,
        trace=trace,
    )
    return out, trace, sched


@pytest.mark.parametrize("cap", [1, 2, 128])
@pytest.mark.parametrize("graph", ["sim/cyclic.gfa", CIRCLE])
def test_node_rule_marks_every_changed_position(graph, cap, cyclic_graphs):
    """The cyclic kernel's rule is exact: in every pass k >= 2 of every
    slice, each position whose output changed from pass k - 1 (for a lane)
    lies in a node the rule marks for that lane (an in-neighbour's end
    column changed as read there), so skipping the unmarked nodes keeps the
    whole-pass results. At the full cap the rule also skips positions."""
    out, trace, sched = _plain_traced(cyclic_graphs[graph], cap)
    send = out[5].to(torch.int64)
    is_start = torch.as_tensor(sched.is_start)
    preds = torch.as_tensor(sched.pred_nodes)
    slots = torch.as_tensor(sched.node_slot)
    S, P, B = send.shape
    changed = skipped = 0
    for s in range(S):
        passes = [x for k, x in trace if k == s]
        assert 1 <= len(passes) <= cap
        old_end = send[s - 1] if s else torch.zeros((P, B), dtype=torch.int64)
        marks = k3.node_rule_marks(passes, old_end, is_start, preds, slots)
        assert len(marks) == len(passes) - 1
        for k, mark in enumerate(marks, start=2):
            diff = (passes[k - 1] != passes[k - 2]).any(0)
            assert not bool((diff & ~mark).any()), (s, k)
            changed += int(diff.sum())
            skipped += int((~mark).sum())
    if cap == 128:
        assert changed > 0 and skipped > 0


@pytest.mark.parametrize("graph", ["sim/cyclic.gfa",
                                   "torch/circular_i/graph.gfa", CIRCLE])
def test_cyclic_schedule_nodes_are_contiguous_runs(graph, cyclic_graphs):
    """The premise of the cyclic kernel's node loop, on every cyclic
    fixture: each node's positions are one contiguous run of the schedule
    that starts at an is_start position. ``node_tables`` numbers the nodes
    by that run's rank and lists each edge once among the in- and once
    among the out-neighbours."""
    from graphaligner_tpu_torch.core.engine import build_schedule as tsched
    from graphaligner_tpu_torch.graph import load_alignment_graph as load

    sched = tsched(load(cyclic_graphs[graph]))
    assert sched.cyclic
    starts = np.nonzero(sched.is_start)[0]
    assert starts[0] == 0 and len(starts) == sched.num_nodes
    bounds = np.append(starts, len(sched.code))
    for a, z in zip(bounds[:-1], bounds[1:]):
        assert (sched.node_slot[a:z] == sched.node_slot[a]).all()
    assert sorted(sched.node_slot[starts]) == list(range(sched.num_nodes))
    nodes, npred, succ_ptr, succ = k3.node_tables(
        *(torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)) for a in (
            sched.is_start, sched.is_source_start, sched.pred_nodes,
            sched.node_slot)), num_nodes=sched.num_nodes)
    assert (nodes.numpy() >> 1).tolist() == bounds.tolist()
    assert ((nodes.numpy()[:-1] & 1) == sched.is_source_start[starts]).all()
    rank = np.empty(sched.num_nodes, np.int64)
    rank[sched.node_slot[starts]] = np.arange(sched.num_nodes)
    pr = sched.pred_nodes[starts]
    assert (npred.numpy() == np.where(pr >= 0, rank[np.maximum(pr, 0)],
                                      -1)).all()
    edges = {(int(p), j) for j, row in enumerate(npred.tolist())
             for p in row if p >= 0}
    out_edges = {(j, int(v)) for j in range(sched.num_nodes)
                 for v in succ[succ_ptr[j]:succ_ptr[j + 1]].tolist()}
    assert out_edges == edges and len(succ) == int((npred >= 0).sum())


def test_node_tables_reject_split_nodes():
    """A schedule whose node runs are split raises, on the CPU too."""
    z = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    preds = torch.full((4, 1), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        k3.node_tables(z, z, preds, torch.tensor([0, 1, 1, 0],
                                                 dtype=torch.int32),
                       num_nodes=2)


def test_schedule_tables_kept_until_the_schedule_changes(monkeypatch):
    """The cyclic route builds its node tables once a schedule: the same
    tensors, unchanged, give back the same tables; another schedule, or
    one written in place, is built anew and equals ``node_tables``."""
    from graphaligner_tpu.graph import graph_from_gfa_file

    sched = build_schedule(graph_from_gfa_file(str(FIX / "sim" / "cyclic.gfa")))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32))

    monkeypatch.setattr(k3, "_TABLES", None)
    args = [t(a) for a in (sched.is_start, sched.is_source_start,
                           sched.pred_nodes, sched.node_slot)]
    first = k3.schedule_tables(*args, sched.num_nodes)
    assert k3.schedule_tables(*args, sched.num_nodes) is first
    copies = [a.clone() for a in args]
    again = k3.schedule_tables(*copies, sched.num_nodes)
    assert again is not first
    for g, w in zip(again, k3.node_tables(*args, sched.num_nodes)):
        assert torch.equal(g, w)
    copies[1][0] ^= 1  # the first node's source flag, written in place
    flipped = k3.schedule_tables(*copies, sched.num_nodes)
    assert flipped is not again
    assert int(flipped[0][0] ^ again[0][0]) == 1


def test_cyclic_shape_fits_shared_memory(monkeypatch):
    """The cyclic route keeps its node tables and store in shared memory
    where they fit beside each warp's need bits and ring, the store in
    device memory for the circle's 8,386 nodes; the constants force either
    out."""
    L, T = k3.WAVE_LANES, k3.CYC_CHUNK
    ring = 4 * (2 * 2 + 2 * T * (L + 1))
    W, tab, sto, smem = k3.cyclic_shape(42, 2, 32)
    assert (W, tab, sto) == (4, True, True)
    assert smem == 4 * (43 + 42 * 2) + 4 * (ring + 4 * 42 * 6 * L)
    assert k3.cyclic_shape(42, 2, 12)[0] == 2
    W, tab, sto, smem = k3.cyclic_shape(8386, 2, 16)
    assert (W, tab, sto) == (2, True, False) and smem <= k3.SMEM_LIMIT
    monkeypatch.setattr(k3, "CYC_STORE_SMEM", False)
    assert k3.cyclic_shape(42, 2, 32)[1:3] == (True, False)
    monkeypatch.setattr(k3, "CYC_TABLE_SMEM", False)
    assert k3.cyclic_shape(42, 2, 32)[1:3] == (False, False)
    with pytest.raises(NotImplementedError, match="shared memory"):
        k3.cyclic_shape(10_000_000, 2, 8)


def test_pass_cap_flags_non_convergence():
    """A cyclic graph cut to one pass cannot reach its fixpoint: every lane
    is flagged, as the column engine's while loop flags the batch."""
    from graphaligner_tpu.graph import graph_from_gfa_file

    sched = build_schedule(graph_from_gfa_file(str(FIX / "sim" / "cyclic.gfa")))
    eq = _build_eq_vectors(_codes(3, 2, 1), _MATCH_TABLE, 1).view(np.int32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32))

    *_, flags = k3.exhaustive(
        torch.as_tensor(eq), t(sched.code), t(sched.is_start),
        t(sched.is_source_start), t(sched.pred_nodes), t(sched.node_slot),
        num_nodes=sched.num_nodes, cyclic=True, max_passes=1,
    )
    assert bool(flags.all())


def test_wrapper_checks_and_cuda_route(monkeypatch):
    """Bad dtypes and shapes raise; a CUDA launch without nvcc raises
    rather than running the plain version, on both routes."""
    from graphaligner_tpu_torch.ops import _build

    P, B = 3, 2
    z = torch.zeros(P, dtype=torch.int32)
    eq = torch.zeros((1, 5, 2, B), dtype=torch.int32)
    preds = torch.full((P, 1), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        k3.exhaustive(eq.to(torch.int64), z, z, z, preds, z, num_nodes=1,
                      cyclic=False)
    with pytest.raises(ValueError, match="eq must be"):
        k3.exhaustive(eq[:, :4], z, z, z, preds, z, num_nodes=1, cyclic=False)

    def no_nvcc(name):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "library", no_nvcc)
    n0 = (k3.LAUNCHES_WAVEFRONT, k3.LAUNCHES_SERIAL)
    for cyclic in (False, True):
        with pytest.raises(RuntimeError, match="nvcc"):
            k3._launch(eq, z, z, z, preds, z, num_nodes=1, cyclic=cyclic,
                       max_passes=128)
    assert (k3.LAUNCHES_WAVEFRONT, k3.LAUNCHES_SERIAL) == n0


@pytest.mark.parametrize("cyclic", [False, True])
def test_launch_routes_acyclic_to_wavefront_and_cyclic_to_serial(
        cyclic, monkeypatch):
    """On the card an acyclic schedule launches the slice wavefront and a
    cyclic one the serial fixpoint kernel, with the pass cap."""
    routes = []
    monkeypatch.setattr(
        k3, "_launch_wavefront",
        lambda *a, **kw: routes.append(("wavefront", kw)) or "w")
    monkeypatch.setattr(
        k3, "_launch_serial",
        lambda *a, **kw: routes.append(("serial", kw)) or "s")
    out = k3._launch(*[torch.zeros(1, dtype=torch.int32)] * 6, num_nodes=7,
                     cyclic=cyclic, max_passes=5)
    if cyclic:
        assert out == "s"
        assert routes == [("serial", {"num_nodes": 7, "max_passes": 5})]
    else:
        assert out == "w"
        assert routes == [("wavefront", {"num_nodes": 7})]


def test_wave_shape_fits_shared_memory():
    """The wavefront takes up to 16 slice-warps, fewer when the slices are
    fewer or its staging rings would not fit in a block's shared memory."""
    L = k3.WAVE_LANES
    T, W, smem = k3.wave_shape(11, 2)
    assert (T, W) == (k3.WAVE_CHUNK, 11)
    assert smem == 4 * (W * 2 * T * L + (W + 1) * (4 * T + 1 + T * 2))
    assert k3.wave_shape(160, 2)[1] == 16
    T, W, smem = k3.wave_shape(160, 200)
    assert 1 <= W < 16 and smem <= k3.SMEM_LIMIT
    assert 4 * ((W + 1) * 2 * T * L + (W + 2) * (4 * T + 1 + T * 200)) \
        > k3.SMEM_LIMIT
    with pytest.raises(NotImplementedError, match="shared memory"):
        k3.wave_shape(4, 2000)

ACYCLIC = ["smallexample/sub_test.vg", "sim/bubbles.vg", "longsim/graph.vg",
           "gwws_fail_ex1.vg", "giantband/graph.vg", "sim/overlap.gfa"]


@pytest.mark.parametrize("graph", ACYCLIC)
def test_acyclic_schedule_preds_precede_their_starts(graph):
    """The premise of the wavefront's unreset node store: on an acyclic
    graph every in-neighbour named at a node start is scheduled, and so
    written, earlier in the slice."""
    from graphaligner_tpu_torch.core.engine import build_schedule
    from graphaligner_tpu_torch.graph import load_alignment_graph as load

    sched = build_schedule(load(str(FIX / graph)))
    assert not sched.cyclic
    starts = np.nonzero(sched.is_start)[0]
    assert sorted(sched.node_slot[starts]) == list(range(sched.num_nodes))
    first = np.empty(sched.num_nodes, np.int64)  # each node's first step
    first[sched.node_slot[starts]] = starts
    preds = sched.pred_nodes[starts]
    has = preds >= 0
    assert has.any()
    assert (first[np.where(has, preds, 0)][has]
            < np.broadcast_to(starts[:, None], preds.shape)[has]).all()
    assert (sched.pred_nodes[~sched.is_start] == -1).all()
