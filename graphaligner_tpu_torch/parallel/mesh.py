# Port of graphaligner_tpu/parallel/mesh.py: a list of torch devices in place of a jax Mesh, one call per shard in place of shard_map.
"""Data-parallel read sharding over a device mesh.

The unit of parallelism is a read (as in the reference's thread pool,
Aligner.cpp:290); here a batch of reads is split along the mesh's one
axis into contiguous shards of equal width, one a device. The graph index
and column schedule are replicated per device, so the alignment of one
read never crosses a card and the computation needs zero collectives —
each shard's work is issued on its own device, and results are gathered
host-side exactly like the reference's per-thread result vectors
(Aligner.cpp:301-306).
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A one-axis device mesh: ``devices`` (torch devices, one a shard; a
    device may appear more than once) and the axis name."""

    def __init__(self, devices, axis: str = "dp"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              devices=None) -> Mesh:
    """The first ``n_devices`` (all by default) of ``devices``, or of the
    visible CUDA cards when no list is given; raises where there is no
    card. A list may repeat a device: two shards on one card."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible (pass devices= for a "
                "mesh of CPU devices)"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(
                f"make_mesh: {n_devices} devices asked, {len(devices)} there"
            )
        devices = devices[:n_devices]
    return Mesh(devices, axis)


def _lane_slices(B: int, mesh: Mesh):
    if B % mesh.size:
        raise ValueError(f"a batch of {B} does not split into {mesh.size} "
                         "equal shards")
    w = B // mesh.size
    return [slice(d * w, (d + 1) * w) for d in range(mesh.size)]


def shard_reads_aligner(graph, mesh: Mesh, axis: str = "dp"):
    """Returns (BatchAligner, run): run(read_codes [B, num_slices * 64]
    uint8, num_slices) aligns the batch in exhaustive mode with the batch
    split over the mesh and the schedule replicated, K3 on each shard's
    lanes on its device, and returns the six slabs (vp_lo, vp_hi, vn_lo,
    vn_hi, sbs, score_end) [S, P, B] and nonconv [B] on the mesh's first
    device."""
    from ..core.engine import _MATCH_TABLE, BatchAligner, _build_eq_vectors
    from ..core.engine_banded import device_guard
    from ..ops.exhaustive import exhaustive

    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    ba = BatchAligner(graph, mesh.devices[0])
    scheds = {}
    for dev in mesh.devices:
        scheds.setdefault(dev, tuple(t.to(dev) for t in ba._dev_sched))

    def run(read_codes: np.ndarray, num_slices: int):
        eq = _build_eq_vectors(read_codes, _MATCH_TABLE, num_slices).view(
            np.int32)
        parts = []
        for dev, sl in zip(mesh.devices, _lane_slices(eq.shape[-1], mesh)):
            with device_guard(dev):
                parts.append(exhaustive(
                    torch.as_tensor(np.ascontiguousarray(eq[..., sl]),
                                    device=dev),
                    *scheds[dev],
                    num_nodes=ba.sched.num_nodes,
                    cyclic=ba.sched.cyclic,
                ))
        first = mesh.devices[0]
        return tuple(
            torch.cat([p[k].to(first) for p in parts], dim=-1)
            for k in range(len(parts[0]))
        )

    return ba, run


def shard_banded_scan(graph, mesh: Mesh, Nm: int = 8, Cm: int = 64,
                      axis: str = "dp"):
    """One banded DP round (``core.engine_banded.banded_scan``) sharded
    over the mesh: the problem batch is split along ``axis``, the graph
    tables are replicated, and every lane's band scan runs entirely on its
    device (zero collectives — the multi-card layout mirrors the
    reference's independent per-thread reads, Aligner.cpp:290).

    Returns (tables, run) where run(codes, seq_lens, steps, start, bw,
    *seed_carry, S_max=...) -> the banded_scan output dict, each shard's
    lanes computed on its device and the batch (last) axis joined on the
    mesh's first device."""
    from ..core.engine_banded import banded_scan, device_guard
    from ..core.reach import ensure_reach
    from ..core.tables import build_graph_tables, device_tables, reach_fits

    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    tables = build_graph_tables(graph)

    def run(codes, seq_lens, steps, start, bw, init_ids, init_send,
            init_nmin, init_nend, init_min, *, S_max: int):
        # bands projected as the aligner projects them: through the reach
        # table of the round's widest band where the graph has one
        reach = (ensure_reach(tables, int(np.max(bw)) + 63)
                 if reach_fits(tables.num_nodes) else None)
        dts = {}
        for dev in mesh.devices:
            dts.setdefault(dev, device_tables(tables, reach, dev))
        lane_args = (codes, seq_lens, steps, start)
        carry = (init_ids, init_send, init_nmin, init_nend, init_min)
        parts = []
        for dev, sl in zip(mesh.devices, _lane_slices(len(codes), mesh)):
            with device_guard(dev):
                parts.append(banded_scan(
                    dts[dev], *(np.asarray(a)[sl] for a in lane_args),
                    np.asarray(bw)[:, sl],
                    *(np.asarray(a)[sl] for a in carry),
                    S_max=S_max, Nm=Nm, Cm=Cm,
                ))
        first = mesh.devices[0]
        return {
            key: torch.cat([p[key].to(first) for p in parts], dim=-1)
            for key in parts[0]
        }

    return tables, run
