"""Graph tables and read encodings of the banded engine.

The numpy pieces below are copied from modules of ``graphaligner_tpu``
that need jax at module level; each carries a note naming its source. The
read alphabet and match table are those of ``core.engine``.
``device_tables`` turns a ``BandedGraphTables`` plus its reach table, if
the graph has a usable one, into the port's tensors on one device.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..graph.alignment_graph import AlignmentGraph
from ..graph.scc import condensation
from .engine import _MATCH_TABLE, _READ_CODE


# copied from graphaligner_tpu/core/backtrace_device.py:44-45 ---------------
# backtrace-time character match: like the DP Eq table but read-side 'N'
# matches everything INCLUDING dummy '-' cells.
_BT_MATCH = _MATCH_TABLE.copy()
_BT_MATCH[_READ_CODE["N"], :] = True


# copied from graphaligner_tpu/core/engine_banded.py:50-118 -----------------
INF = np.int32(1 << 20)  # band-absent score (real scores < 2^18)
EMPTY = np.int32(2**31 - 1)  # empty node slot sentinel
PRI_RANGE = 1024  # projection priority range; requires bandwidth+64 < 1023
INF_PRI = np.int32(PRI_RANGE - 1)
I32MAX = np.int32(2**31 - 1)


@dataclass
class BandedGraphTables:
    """Host copies of the device-resident graph arrays for the banded
    engine (uploaded once per graph)."""

    node_len: np.ndarray  # [N] int32
    node_start: np.ndarray  # [N] int32
    seq_codes: np.ndarray  # [BP] int32 (0-3 bases, 4 dummy)
    in_nbrs: np.ndarray  # [N, K_in] int32, -1 pad
    out_nbrs: np.ndarray  # [N, K_out] int32, -1 pad
    topo_rank: np.ndarray  # [N] int32, unique, ascending ~ topo order
    pos_to_node: np.ndarray  # [BP] int32 (backtrace walk)
    node_end: np.ndarray  # [N] int32 (= node_start + node_len)
    k_in: int
    k_out: int
    num_nodes: int
    # lazily built by core.reach.ensure_reach (GA_PROJ=reach): [2, N, K]
    # packed reach sets, the d_max they cover, or -2 when the graph is
    # unfit for the precomputed-projection mode
    reach_tbl: np.ndarray | None = None
    reach_dmax: int = -1

    def device_args(self):
        return (
            self.node_len,
            self.node_start,
            self.seq_codes,
            self.in_nbrs,
            self.out_nbrs,
            self.topo_rank,
        )


def build_graph_tables(graph: AlignmentGraph) -> BandedGraphTables:
    n = graph.node_count

    def pad_adj(ptr, idx):
        deg = np.diff(ptr)
        k = max(1, int(deg.max()))
        out = np.full((n, k), -1, dtype=np.int32)
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)
        cols = np.arange(len(idx), dtype=np.int64) - np.repeat(ptr[:-1], deg)
        out[rows, cols] = idx
        return out, k

    in_nbrs, k_in = pad_adj(graph.in_ptr, graph.in_idx)
    out_nbrs, k_out = pad_adj(graph.out_ptr, graph.out_idx)
    _, _, _, topo_order = condensation(graph.out_ptr, graph.out_idx)
    topo_rank = np.empty(n, dtype=np.int32)
    topo_rank[np.asarray(topo_order)] = np.arange(n, dtype=np.int32)
    return BandedGraphTables(
        node_len=graph.node_len.astype(np.int32),
        node_start=graph.node_start.astype(np.int32),
        seq_codes=graph.seq_codes.astype(np.int32),
        in_nbrs=in_nbrs,
        out_nbrs=out_nbrs,
        topo_rank=topo_rank,
        pos_to_node=graph.pos_to_node.astype(np.int32),
        node_end=(graph.node_start + graph.node_len).astype(np.int32),
        k_in=k_in,
        k_out=k_out,
        num_nodes=n,
    )


# copied from graphaligner_tpu/core/engine_banded.py:1311-1341 --------------
def band_hash_np(ids_rows: np.ndarray) -> np.ndarray:
    """Host mirror of the engine's band-row hash (see the ids_sub
    construction above and ga_native.cpp's checker — keep in sync):
    slot-weighted uint32 mix over the last axis ([..., Nm] topo-sorted,
    EMPTY-padded band ids) -> int32 hashes."""
    nm = ids_rows.shape[-1]
    w = ((np.arange(nm, dtype=np.uint64) + 1) * np.uint64(2654435761)).astype(
        np.uint32
    )
    h = np.asarray(
        np.sum(ids_rows.astype(np.uint32) * w, axis=-1, dtype=np.uint32)
    )
    return h.view(np.int32)


def make_seed_carry(tables: BandedGraphTables, start_nodes, Nm: int, Cm: int):
    """Initial carry for seeded problems: band = the seed node at score 0
    (reference getInitialSliceOnlyOneNode, GraphAligner.h:2945-2960)."""
    start_nodes = np.asarray(start_nodes, dtype=np.int32)
    B = len(start_nodes)
    ids = np.full((B, Nm), EMPTY, dtype=np.int32)
    ids[:, 0] = start_nodes
    lens = tables.node_len[start_nodes]
    cell_send = np.full((B, Cm), INF, dtype=np.int32)
    cell_send[np.arange(Cm)[None, :] < lens[:, None]] = 0
    node_min = np.full((B, Nm), INF, dtype=np.int32)
    node_min[:, 0] = 0
    node_end = np.full((B, Nm), INF, dtype=np.int32)
    node_end[:, 0] = 0
    mins = np.zeros(B, dtype=np.int32)
    return ids, cell_send, node_min, node_end, mins


# --------------------------------------------------------------------------
@dataclass
class DeviceTables:
    """The graph state the banded scan reads, as int32 tensors on one
    device: per-node tables, the packed reach sets (None where the scan
    projects bands iteratively) and the read-code match LUTs (``bits_lut``
    for the DP Eq words, ``bt_bits_lut`` for the walk)."""

    node_len: torch.Tensor  # [N]
    node_start: torch.Tensor  # [N]
    seq_codes: torch.Tensor  # [BP]
    in_nbrs: torch.Tensor  # [N, K_in]
    out_nbrs: torch.Tensor  # [N, K_out]
    topo_rank: torch.Tensor  # [N]
    reach: torch.Tensor | None  # [2, N, K]
    bits_lut: torch.Tensor  # [R] read code -> 5-bit graph-code match mask
    bt_bits_lut: torch.Tensor  # [R] the same under the backtrace's N rule
    k_in: int
    num_nodes: int
    device: torch.device

    def to(self, device) -> "DeviceTables":
        """The same tables on ``device`` (a device mesh keeps one copy on
        each card it spans)."""
        device = torch.device(device)
        if device == self.device:
            return self
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return replace(self, device=device, **moved)


def match_bits(table: np.ndarray) -> np.ndarray:
    """[R, 5] bool match table -> [R] int32 5-bit masks."""
    out = np.zeros(table.shape[0], dtype=np.int32)
    for g in range(5):
        out |= table[:, g].astype(np.int32) << g
    return out


def reach_fits(num_nodes: int) -> bool:
    """Whether the banded scan may project through a reach table on a graph
    of ``num_nodes`` digraph nodes (graphaligner_tpu/core/engine_banded.py
    :199-201 projects iteratively from I32MAX // PRI_RANGE - 1 on)."""
    return num_nodes < (int(I32MAX) // PRI_RANGE) - 1


def device_tables(tables, reach: np.ndarray | None, device) -> DeviceTables:
    """``tables``: a BandedGraphTables of either package (numpy);
    ``reach``: its [2, N, K] reach table from core.reach.ensure_reach, or
    None. The scan projects through the table where there is one, and
    through the iterative projection (``ops.project_band``) where there is
    none: a graph that ``ensure_reach`` finds unfit, or one past
    ``reach_fits``'s size, for which a table is refused."""
    if reach is not None and not reach_fits(tables.num_nodes):
        raise ValueError(
            f"a reach table for a graph of {tables.num_nodes} nodes: past "
            "reach_fits the scan projects iteratively; pass None")

    def t(a):
        return torch.as_tensor(
            np.ascontiguousarray(a, dtype=np.int32), device=device
        )

    return DeviceTables(
        node_len=t(tables.node_len),
        node_start=t(tables.node_start),
        seq_codes=t(tables.seq_codes),
        in_nbrs=t(tables.in_nbrs),
        out_nbrs=t(tables.out_nbrs),
        topo_rank=t(tables.topo_rank),
        reach=None if reach is None else t(reach),
        bits_lut=t(match_bits(_MATCH_TABLE)),
        bt_bits_lut=t(match_bits(_BT_MATCH)),
        k_in=int(tables.k_in),
        num_nodes=int(tables.num_nodes),
        device=torch.device(device),
    )
