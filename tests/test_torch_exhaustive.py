"""K3's plain version against graphaligner_tpu's exhaustive-mode DP.

``exhaustive_plain`` must give the six slabs of
``ops.pallas.exhaustive.make_kernel`` (run through the Pallas interpreter:
``pallas_call`` is wrapped with ``interpret=True`` from outside the
package) and of ``core.engine._align_batch_device``, the XLA column engine
whose cyclic fixpoint the port carries. Inputs are random reads drawn from
a numpy seed; tolerance zero (everything is integer).
"""

import functools
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
