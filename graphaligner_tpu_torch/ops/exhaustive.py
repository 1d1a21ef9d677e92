"""Exhaustive-mode column DP (kernel K3): wrapper and plain version.

``exhaustive`` computes what ``graphaligner_tpu.ops.pallas.exhaustive``
(``make_kernel`` / ``align_exhaustive_pallas``) computes and what
``graphaligner_tpu.core.engine._align_batch_device`` computes: for each
read lane and each 64-row slice ``s`` it sweeps the P schedule positions in
order — the within-node Myers advance with row -1 closed at
``R[t] = min(old_end[t], sbs + 1)``, the score-space merge over the
in-neighbours' last columns at node starts, and the row-0 free start of
source nodes at ``s == 0`` — and returns the packed slabs
(vp_lo, vp_hi, vn_lo, vn_hi, sbs, send), each int32 [S, P, B] (the four
words are uint32 bit patterns), plus a per-lane non-convergence flag.
``old_end`` of slice ``s`` is ``send[s - 1]`` (0 at ``s = 0``).

Each slice starts from a node store reset to INF. On a cyclic graph the
slice is swept in whole passes, back-edge predecessors reading the previous
pass's store, until no output of the lane changes, for at most
``max_passes`` passes (``_align_batch_device``'s fixpoint, per lane); a
lane still changing after the last pass is flagged.

On the card the acyclic and the cyclic graph take two kernels of
``csrc/exhaustive.cu``: a slice wavefront (one warp per slice, lanes across
its threads) and the cyclic kernel that carries the fixpoint node by node,
recomputing in each pass after the first only the nodes whose inputs
changed (``node_rule_marks`` states the rule on the plain version's
passes); each route has its launch count. A CPU tensor runs
``exhaustive_plain``, the same computation in plain torch ops, in whole
passes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .wordops import M32, i32, myers_advance, u32

INF = 1 << 30
WORD = 64

# kernel launches since the last reset (plain counts, read by the smoke run)
LAUNCHES_WAVEFRONT = 0
LAUNCHES_SERIAL = 0
# the last cyclic launch's pass log, int32 [S, max_passes, 3]: per slice and
# pass, the warps that ran it, the nodes and the positions they recomputed
PASS_LOG = None
# the cyclic route's node tables of the last schedule it launched on: (the
# schedule tensors, their versions and num_nodes, the tables)
_TABLES = None

# the wavefront's shape: read lanes a warp carries (each on 32 / lanes
# threads; csrc/exhaustive.cu EX_WAVE_G), schedule positions a chunk,
# slice-warps a block at most (csrc/exhaustive.cu EX_MAX_WARPS)
WAVE_LANES = 8
WAVE_CHUNK = 64
WAVE_WARPS = 16
SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block can opt into
# the cyclic route: positions a staged chunk (csrc/exhaustive.cu
# EX_CYC_CHUNK), warps a block at most (EX_CYC_MAX_WARPS), and whether its
# node tables and its node store may sit in shared memory (else they stay
# in device memory)
CYC_CHUNK = 32
CYC_WARPS = 4
CYC_TABLE_SMEM = True
CYC_STORE_SMEM = True


def exhaustive(eq, code, is_start, is_source_start, pred_nodes, node_slot, *,
               num_nodes: int, cyclic: bool, max_passes: int = 128):
    """eq [S, 5, 2, B] (uint32 Eq words: graph code x (lo, hi) x lane);
    code, is_start, is_source_start, node_slot [P]; pred_nodes [P, K]
    (-1 pad). All int32. Returns (vp_lo, vp_hi, vn_lo, vn_hi, sbs, send)
    int32 [S, P, B] and nonconv bool [B]. ``cyclic`` False promises that
    every in-neighbour of a node start is scheduled before it."""
    S, _, _, B = eq.shape
    P, K = pred_nodes.shape
    args = (eq, code, is_start, is_source_start, pred_nodes, node_slot)
    shapes = ((S, 5, 2, B), (P,), (P,), (P,), (P, K), (P,))
    for name, a, shape in zip(
        ("eq", "code", "is_start", "is_source_start", "pred_nodes",
         "node_slot"), args, shapes,
    ):
        if a.dtype != torch.int32 or tuple(a.shape) != shape:
            raise ValueError(f"exhaustive: {name} must be int32 {shape}, "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device != eq.device:
            raise ValueError("exhaustive: inputs on different devices")
    if S < 1 or P < 1 or K < 1 or num_nodes < 1 or max_passes < 1:
        raise ValueError("exhaustive: empty schedule, batch or pass cap")
    if eq.device.type == "cpu":
        return exhaustive_plain(*args, num_nodes=num_nodes, cyclic=cyclic,
                                max_passes=max_passes)
    if eq.device.type != "cuda":
        raise ValueError(f"exhaustive: unsupported device {eq.device}")
    return _launch(*[a.contiguous() for a in args], num_nodes=num_nodes,
                   cyclic=cyclic, max_passes=max_passes)


def _launch(*args, num_nodes, cyclic, max_passes):
    """The route: the cyclic fixpoint kernel on a cyclic graph, the slice
    wavefront otherwise."""
    if cyclic:
        return _launch_serial(*args, num_nodes=num_nodes,
                              max_passes=max_passes)
    return _launch_wavefront(*args, num_nodes=num_nodes)


def wave_shape(S: int, K: int):
    """(T, W, shared bytes) of a wavefront launch: T positions a chunk, W
    slice-warps a block, the most (up to ``WAVE_WARPS``) whose rings fit in
    a block's shared memory."""
    L, T = WAVE_LANES, WAVE_CHUNK
    for W in range(min(S, WAVE_WARPS), 0, -1):
        smem = 4 * (W * 2 * T * L + (W + 1) * (4 * T + 1 + T * K))
        if smem <= SMEM_LIMIT:
            return T, W, smem
    raise NotImplementedError(
        f"the K3 wavefront for in-degree {K} at {T} positions a chunk does "
        "not fit in shared memory"
    )


def _launch_wavefront(eq, code, is_start, is_source_start, pred_nodes,
                      node_slot, *, num_nodes):
    global LAUNCHES_WAVEFRONT
    S, _, _, B = eq.shape
    P, K = pred_nodes.shape
    T, W, smem = wave_shape(S, K)
    dev = eq.device
    out = torch.empty((6, S, P, B), dtype=torch.int32, device=dev)
    store = torch.empty((W, num_nodes, 6, B), dtype=torch.int32, device=dev)
    lib = _build.library("exhaustive")
    fn = lib.ga_exhaustive_wavefront
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p
    ]
    err = fn(
        *[a.data_ptr() for a in (eq, code, is_start, is_source_start,
                                 pred_nodes, node_slot, out, store)],
        S, P, K, num_nodes, B, T, W, smem, _build.stream_handle(dev),
    )
    _build.check(err, "exhaustive wavefront")
    LAUNCHES_WAVEFRONT += 1
    return (*out.unbind(0), torch.zeros(B, dtype=torch.bool, device=dev))


def node_tables(is_start, is_source_start, pred_nodes, node_slot,
                num_nodes: int):
    """The cyclic route's node tables, nodes numbered by schedule rank:
    nodes int32 [N + 1] (first position * 2 + source flag; nodes[N] = 2P),
    npred [N, K] (in-neighbours' ranks, -1 pad), and the out-neighbours as
    CSR, succ_ptr [N + 1] and succ [E]. Raises unless each node's positions
    are contiguous and start at an is_start position."""
    P, K = pred_nodes.shape
    dev = pred_nodes.device
    starts = torch.nonzero(is_start).flatten()
    N = num_nodes
    node_of = torch.cumsum((is_start != 0).to(torch.int64), 0) - 1
    slot_of = node_slot[starts].to(torch.int64)
    if (starts.numel() != N or not bool(is_start[0])
            or not torch.equal(node_slot, node_slot[starts][node_of])
            or not torch.equal(torch.bincount(slot_of, minlength=N),
                               torch.ones(N, dtype=torch.int64, device=dev))):
        raise ValueError("exhaustive: each node's positions must be "
                         "contiguous, one run a node, starting at is_start")
    rank = torch.empty(N, dtype=torch.int64, device=dev)
    rank[slot_of] = torch.arange(N, device=dev)
    first = torch.cat([starts, torch.tensor([P], device=dev)])
    source = torch.cat([is_source_start[starts].to(torch.int64) != 0,
                        torch.zeros(1, dtype=torch.bool, device=dev)])
    nodes = (first * 2 + source).to(torch.int32)
    pr = pred_nodes[starts].to(torch.int64)
    npred = torch.where(pr >= 0, rank[pr.clamp(min=0)], -1)
    src = npred.flatten()
    dst = torch.arange(N, device=dev).repeat_interleave(K)
    keep = src >= 0
    src, dst = src[keep], dst[keep]
    succ = dst[torch.argsort(src * N + dst)].to(torch.int32)
    succ_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(torch.bincount(src, minlength=N), 0)])
    return nodes, npred.to(torch.int32), succ_ptr.to(torch.int32), succ


def schedule_tables(is_start, is_source_start, pred_nodes, node_slot,
                    num_nodes: int):
    """``node_tables`` of the schedule, built (with a device sync) only when
    it is not the one the last call was given: the engine launches the
    cyclic route on one schedule, batch after batch."""
    global _TABLES
    sched = (is_start, is_source_start, pred_nodes, node_slot)
    key = tuple(t._version for t in sched) + (num_nodes,)
    if (_TABLES is None or _TABLES[1] != key
            or any(a is not b for a, b in zip(_TABLES[0], sched))):
        _TABLES = (sched, key, node_tables(*sched, num_nodes))
    return _TABLES[2]


def cyclic_shape(N: int, K: int, B: int):
    """(W, table_smem, store_smem, shared bytes) of a cyclic launch: W warps
    a block (up to ``CYC_WARPS``), the node tables and the node store in
    shared memory where they fit (the store first, as it is read at every
    in-neighbour of a node start), the most warps that fit with them."""
    L, T = WAVE_LANES, CYC_CHUNK
    table = 4 * (N + 1 + N * K)
    ring = 4 * (2 * ((N + 31) // 32) + 2 * T * (L + 1))
    store = 4 * N * 6 * L
    for tab, sto in ((True, True), (False, True), (True, False),
                     (False, False)):
        if (tab and not CYC_TABLE_SMEM) or (sto and not CYC_STORE_SMEM):
            continue
        for W in range(min(-(-B // L), CYC_WARPS), 0, -1):
            smem = tab * table + W * (ring + sto * store)
            if smem <= SMEM_LIMIT:
                return W, tab, sto, smem
    raise NotImplementedError(
        f"the K3 cyclic route's need bits for {N} nodes do not fit in shared "
        "memory"
    )


def _launch_serial(eq, code, is_start, is_source_start, pred_nodes,
                   node_slot, *, num_nodes, max_passes):
    global LAUNCHES_SERIAL, PASS_LOG
    S, _, _, B = eq.shape
    P, K = pred_nodes.shape
    dev = eq.device
    lib = _build.library("exhaustive")
    tables = schedule_tables(is_start, is_source_start, pred_nodes,
                             node_slot, num_nodes)
    W, tab, sto, smem = cyclic_shape(num_nodes, K, B)
    out = torch.empty((6, S, P, B), dtype=torch.int32, device=dev)
    store = (torch.empty(1, dtype=torch.int32, device=dev) if sto else
             torch.empty((num_nodes, 6, B), dtype=torch.int32, device=dev))
    nonconv = torch.empty((B,), dtype=torch.int32, device=dev)
    plog = torch.zeros((S, max_passes, 3), dtype=torch.int32, device=dev)
    fn = lib.ga_exhaustive_cyclic
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    err = fn(
        *[a.data_ptr() for a in (eq, code, *tables, out, store, nonconv,
                                 plog)],
        S, P, K, num_nodes, B, max_passes, W, int(tab), int(sto), smem,
        _build.stream_handle(dev),
    )
    _build.check(err, "exhaustive cyclic")
    LAUNCHES_SERIAL += 1
    PASS_LOG = plog
    return (*out.unbind(0), nonconv != 0)


def node_rule_marks(trace, old_end, is_start, pred_nodes, node_slot):
    """The nodes the cyclic kernel's rule recomputes, from one slice's
    passes of ``exhaustive_plain``: ``trace`` its passes' outputs, int64
    [6, P, B] each, pass 1 first; ``old_end`` [P, B]. In pass k >= 2 a node
    is marked for a lane iff an in-neighbour's end column (the four words,
    sbs, and e = sbs == old_end at its last position) as read there changed:
    a forward one (scheduled before the node) from pass k - 1 to k, a back
    one from pass k - 2 to k - 1 (pass 0 being the reset store). Returns,
    for each pass k >= 2, bool [P, B]: each position's node's mark."""
    dev = old_end.device
    N = int((is_start != 0).sum())
    nodes, npred, _, _ = node_tables(is_start, torch.zeros_like(is_start),
                                     pred_nodes, node_slot, N)
    npred = npred.to(torch.int64)
    last = (nodes[1:] >> 1).to(torch.int64) - 1
    node_of = torch.cumsum((is_start != 0).to(torch.int64), 0) - 1
    back = npred >= torch.arange(N, device=dev)[:, None]
    reset = torch.zeros((6, N, old_end.shape[1]), dtype=torch.int64,
                        device=dev)
    reset[4] = INF
    ends = [reset] + [
        torch.cat([x[:5, last], (x[4, last] == old_end[last])[None]])
        for x in trace
    ]
    marks = []
    for k in range(2, len(trace) + 1):
        fwd = (ends[k] != ends[k - 1]).any(0)  # [N, B]
        bck = (ends[k - 1] != ends[k - 2]).any(0)
        mark = torch.zeros_like(fwd)
        for col, is_back in zip(npred.T, back.T):
            p = col.clamp(min=0)
            mark |= ((col >= 0) & is_back)[:, None] & bck[p]
            mark |= ((col >= 0) & ~is_back)[:, None] & fwd[p]
        marks.append(mark[node_of])
    return marks


def _bits(lo, hi, rows):
    """(lo, hi) uint32 words [..., B] as int64 -> their 64 bits [..., 64, B]."""
    return torch.cat([(lo.unsqueeze(-2) >> rows) & 1,
                      (hi.unsqueeze(-2) >> rows) & 1], dim=-2)


def _pack(mask, rows):
    """[64, B] bool -> (lo, hi) uint32 words as int64."""
    w = mask.to(torch.int64) << torch.cat([rows, rows])
    return w[:32].sum(0), w[32:].sum(0)


def exhaustive_plain(eq, code, is_start, is_source_start, pred_nodes,
                     node_slot, *, num_nodes: int, cyclic: bool,
                     max_passes: int = 128, trace: list | None = None):
    """Plain torch version of K3 (any device): a loop over slices, whole
    passes and positions, vectorised over the lanes. Node starts merge in
    score space on [64, B] rows; the other positions take the Myers advance
    on (lo, hi) halves held in int64. ``trace``, when given, receives
    (slice, outputs int64 [6, P, B]) of every pass."""
    S, _, _, B = eq.shape
    P, K = pred_nodes.shape
    dev = eq.device
    rows = torch.arange(32, dtype=torch.int64, device=dev)[:, None]
    ar64 = torch.arange(WORD, dtype=torch.int64, device=dev)[:, None]
    code_l = code.tolist()
    start_l = is_start.tolist()
    source_l = is_source_start.tolist()
    preds_l = pred_nodes.tolist()
    slot_l = node_slot.tolist()
    out = torch.empty((6, S, P, B), dtype=torch.int64, device=dev)
    nonconv = torch.zeros(B, dtype=torch.bool, device=dev)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    store_init = torch.zeros((6, num_nodes, B), dtype=torch.int64, device=dev)
    store_init[4] = INF
    for s in range(S):
        eq_w = u32(eq[s])  # [5, 2, B]
        eq_rows = _bits(eq_w[:, 0], eq_w[:, 1], rows)  # [5, 64, B]
        old_end = out[5, s - 1] if s else torch.zeros((P, B), dtype=torch.int64, device=dev)
        store = store_init.clone()
        passes = 0
        while True:
            passes += 1
            new = torch.empty((P, 6, B), dtype=torch.int64, device=dev)
            vp_lo = vp_hi = vn_lo = vn_hi = zero
            sbs = send = zero + INF
            e_prev = zero
            for t in range(P):
                oe = old_end[t]
                c = code_l[t]
                if start_l[t]:
                    m = eq_rows[c]  # [64, B]
                    merged = torch.full((WORD, B), INF, dtype=torch.int64, device=dev)
                    r_in = zero + INF
                    for pred in preds_l[t]:
                        if pred < 0:
                            continue
                        p = store[:, pred]
                        p_sbs, p_e = p[4], p[5]
                        deltas = _bits(p[0], p[1], rows) - _bits(p[2], p[3], rows)
                        p_scores = p_sbs + deltas.cumsum(0)
                        diag = torch.cat([p_sbs[None], p_scores[:-1]])
                        cost = 1 - m
                        cost[0] = torch.where((m[0] == 1) & (p_e == 1), 0, 1)
                        merged = torch.minimum(
                            merged, torch.minimum(p_scores + 1, diag + cost)
                        )
                        r_in = torch.minimum(r_in, p_sbs + 1)
                    r_t = torch.minimum(oe, r_in)
                    row0 = torch.minimum(merged[0], r_t + 1)
                    if source_l[t] and s == 0:
                        row0 = torch.minimum(row0, r_t + 1 - m[0])
                    merged[0] = row0
                    cur = (merged - ar64).cummin(0).values + ar64
                    d = cur - torch.cat([r_t[None], cur[:-1]])
                    vp_lo, vp_hi = _pack(d > 0, rows)
                    vn_lo, vn_hi = _pack(d < 0, rows)
                    send = cur[WORD - 1]
                else:
                    r_t = torch.minimum(oe, sbs + 1)
                    eq_lo = eq_w[c, 0]
                    eq_g = torch.where(e_prev == 1, eq_lo, eq_lo & (M32 ^ 1))
                    vp_lo, vp_hi, vn_lo, vn_hi, send = myers_advance(
                        eq_g, eq_w[c, 1], vp_lo, vp_hi, vn_lo, vn_hi, send,
                        r_t - sbs,
                    )
                sbs = r_t
                e_prev = (r_t == oe).to(torch.int64)
                col = torch.stack([vp_lo, vp_hi, vn_lo, vn_hi, sbs, send])
                new[t] = col
                col[5] = e_prev
                store[:, slot_l[t]] = col
            new = new.permute(1, 0, 2)
            if trace is not None:
                trace.append((s, new))
            if not cyclic:
                out[:, s] = new
                break
            changed = (
                (new != out[:, s]).any(0).any(0) if passes > 1
                else torch.ones(B, dtype=torch.bool, device=dev)
            )
            out[:, s] = new
            if passes >= max_passes or not bool(changed.any()):
                nonconv |= changed
                break
    slabs = [i32(out[k]) for k in range(4)] + [out[4].to(torch.int32),
                                              out[5].to(torch.int32)]
    return (*slabs, nonconv)
