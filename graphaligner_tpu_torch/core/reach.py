# Copy of graphaligner_tpu/core/reach.py for the torch port (imports point at graphaligner_tpu_torch).
"""Precomputed bounded-distance reach sets for band projection.

The banded engine's projectForwardFromMinScore analog (reference
GraphAligner.h:1110-1159) is a Bellman-Ford relaxation to fixpoint: node
m joins the band iff some qualified seed s has outp0(s) + d*(s, m) <= ew,
where d*(s, m) = min over paths s -> ... -> m of the length-sum of the
strictly-intermediate nodes (the relaxation's per-hop priority growth),
and the per-hop expansion constraint outp <= ew is monotone along a path
so only the final inequality binds.  d* is a pure graph property bounded
by ew - 1 < 1023 (PRI_RANGE), so the whole relaxation can be precomputed
once per graph: for every node, every node within distance d_max plus
its min distance and topo rank.  The per-slice projection then becomes
ONE table gather + ONE dedup sort instead of a 9-12-trip sequential
relaxation loop (the largest fixed per-slice cost in the scan).

Table layout [2, N, K] int32 (see build_reach_table):
  word0[n, k] = reachable node id (-1 pad); entry k=0 is n itself.
  word1[n, k] = topo_rank(id) * 1024 + d - 2^31, with d = 1023 reserved
    as the self marker (real distances are <= d_max <= 1022).  word1
    doubles as the projection sort key: ranks are unique per node, so
    same-node entries are adjacent after one stable sort and cross-node
    order is topo order — exactly the band slot order the engine
    requires.  The -2^31 bias makes int32 ascending order equal the
    UNSIGNED order of rank*1024+d, so ranks use all 22 available bits
    (~4.19M nodes — covers pangenome-scale graphs) instead of the 21 a
    signed packing would allow; the bias is a multiple of 1024, so the
    engine's `word1 & 1023` still extracts d directly.
"""

from __future__ import annotations

import numpy as np

_SENT = np.int64(1) << 40  # distance sentinel during the fixpoint


def _block_fixpoint(node_ids, node_len, out_nbrs, d_max, k_cap, max_rounds):
    """Reach fixpoint for one block of source nodes (each node's list
    evolves independently — only the static adjacency is global).
    Returns (L_id, L_d) int64 arrays [n, R], or None when unfit."""
    n = len(node_ids)
    N = out_nbrs.shape[0]
    lens = node_len.astype(np.int64)
    L_id = out_nbrs[node_ids].astype(np.int64).copy()  # direct nbrs: d=0
    L_d = np.where(L_id >= 0, np.int64(0), _SENT)
    rows = np.arange(n, dtype=np.int64)[:, None]
    for _ in range(max_rounds):
        # expand every entry (m, d) one hop: neighbor w of m gets
        # d + len(m) (m becomes an intermediate) when still <= d_max
        safe = np.clip(L_id, 0, N - 1)
        nb = out_nbrs[safe].astype(np.int64)  # [n, R, K_out]
        nd = L_d + lens[safe]  # [n, R]
        valid = (L_id >= 0)[:, :, None] & (nb >= 0) & (nd[:, :, None] <= d_max)
        cand_id = np.where(valid, nb, np.int64(-1)).reshape(n, -1)
        cand_d = np.where(
            valid, np.broadcast_to(nd[:, :, None], nb.shape), _SENT
        ).reshape(n, -1)
        all_id = np.concatenate([L_id, cand_id], axis=1)
        all_d = np.concatenate([L_d, cand_d], axis=1)
        # dedup by min-d per id: one stable row-wise sort on (id, d)
        key = np.where(all_id >= 0, all_id, np.int64(N)) * np.int64(
            2048
        ) + np.minimum(all_d, np.int64(2047))
        idx = np.argsort(key, axis=1, kind="stable")
        id_s = np.take_along_axis(all_id, idx, axis=1)
        d_s = np.take_along_axis(all_d, idx, axis=1)
        first = (
            np.concatenate(
                [np.ones((n, 1), bool), id_s[:, 1:] != id_s[:, :-1]], axis=1
            )
            & (id_s >= 0)
        )
        cnt = np.cumsum(first, axis=1)
        sizes = cnt[:, -1]
        if int(sizes.max()) >= k_cap:  # k=0 is reserved for self
            return None
        r_new = max(int(sizes.max()), 1)
        pos = np.where(first, cnt - 1, r_new)  # r_new = discard column
        new_id = np.full((n, r_new + 1), -1, np.int64)
        new_d = np.full((n, r_new + 1), _SENT, np.int64)
        new_id[rows, pos] = np.where(first, id_s, np.int64(-1))
        new_d[rows, pos] = np.where(first, d_s, _SENT)
        new_id, new_d = new_id[:, :r_new], new_d[:, :r_new]
        if new_id.shape == L_id.shape and np.array_equal(
            new_id, L_id
        ) and np.array_equal(new_d, L_d):
            return L_id, L_d
        L_id, L_d = new_id, new_d
    return None  # no convergence


def build_reach_table(
    node_len: np.ndarray,
    out_nbrs: np.ndarray,
    topo_rank: np.ndarray,
    d_max: int,
    k_cap: int = 64,
    max_rounds: int = 256,
    block: int = 65536,
) -> np.ndarray | None:
    """All-nodes bounded-distance reach sets, or None when the graph is
    unfit (a reach set exceeds k_cap-1 entries, the fixpoint fails to
    converge in max_rounds, or ranks overflow the rank*1024+d packing).
    Source nodes are processed in blocks so peak build memory stays flat
    at any graph size (each node's fixpoint is independent).

    Args:
      node_len: [N] int32 node lengths in bp.
      out_nbrs: [N, K_out] int32 out-neighbor ids, -1 padded.
      topo_rank: [N] int32, a permutation (unique rank per node).
      d_max: max intermediate-length-sum to keep (= max ew - 1).
    """
    assert 0 <= d_max <= 1022, d_max
    N, _ = out_nbrs.shape
    # the biased packing holds rank*1024+d as a uint32; the max real key
    # must also stay strictly below the engine's I32MAX invalid sentinel
    if N > (1 << 22) - 1:
        return None  # rank packing would overflow the 22 rank bits
    # blocks are fully independent; a threaded build was measured SLOWER
    # (numpy's int64 argsort holds the GIL / memory-bandwidth bound), so
    # they run sequentially — the blocking is for flat peak memory
    parts = []
    for lo in range(0, N, block):
        ids_blk = np.arange(lo, min(lo + block, N))
        part = _block_fixpoint(
            ids_blk, node_len, out_nbrs, d_max, k_cap, max_rounds
        )
        if part is None:
            return None
        parts.append(part)
    R = max(p[0].shape[1] for p in parts)

    def padded(a, fill):
        return np.concatenate(
            [
                np.pad(x, ((0, 0), (0, R - x.shape[1])), constant_values=fill)
                for x in a
            ],
            axis=0,
        )

    L_id = padded([p[0] for p in parts], -1)
    L_d = padded([p[1] for p in parts], _SENT)
    # assemble [2, N, K] with the self entry first (d = 1023 marker)
    ids = np.concatenate([np.arange(N, dtype=np.int64)[:, None], L_id], axis=1)
    ds = np.concatenate(
        [np.full((N, 1), 1023, np.int64), np.minimum(L_d, np.int64(1023))],
        axis=1,
    )
    rank = topo_rank.astype(np.int64)[np.clip(ids, 0, N - 1)]
    # -2^31 bias: int32 ascending == unsigned ascending of rank*1024+d
    # (see module docstring); invalid entries get int32 min (ignored —
    # the engine masks on word0 >= 0 before using the key)
    word1 = np.where(
        ids >= 0, rank * 1024 + ds - (1 << 31), -(np.int64(1) << 31)
    )
    return np.stack([ids, word1]).astype(np.int32)


def ensure_reach(tables, d_max: int, k_cap: int = 64):
    """Build-and-cache the reach table on a BandedGraphTables instance.
    Returns the [2, N, K] table, or None when the graph is unfit (the
    caller falls back to the iterative projection)."""
    import os

    cached_dmax = getattr(tables, "reach_dmax", -1)
    if cached_dmax >= d_max:
        return tables.reach_tbl
    if cached_dmax == -2:  # previously determined unfit
        return None
    max_n = int(os.environ.get("GA_REACH_MAXN", 4_000_000))
    if tables.num_nodes > max_n:
        tables.reach_dmax = -2
        tables.reach_tbl = None
        return None
    tbl = build_reach_table(
        tables.node_len,
        tables.out_nbrs,
        tables.topo_rank,
        d_max,
        k_cap=int(os.environ.get("GA_REACH_K", k_cap)),
    )
    tables.reach_tbl = tbl
    tables.reach_dmax = d_max if tbl is not None else -2
    return tbl
