"""Iterative band projection: wrapper and plain version.

Port of the ``pairwise`` branch of ``project_band`` in
``graphaligner_tpu/core/engine_banded.py`` (projectForwardFromMinScore,
GraphAligner.h:1110-1159): a Bellman-Ford relaxation over a lane's node
slots, used where no reach table projects the band (graphs of 2,097,150
digraph nodes or more, and graphs that ``core.reach.ensure_reach`` finds
unfit).

Each iteration forms E = Nm + Nm * K_out entries (id, pri, outp): the
slots, then each slot's out-neighbours in slot-major order. A neighbour is
a candidate when its parent's ``outp <= ew``; it takes ``pri`` = the
parent's ``outp`` and ``outp = min(pri + len, INF_PRI)``. Each node keeps
its entry of least ``pri``, the first in that order on a tie; the kept
nodes, ordered by topo rank, fill the Nm slots. ``over`` flags a lane that
keeps more than Nm nodes on some iteration. Iterations go on while a live
lane (active and not over) changed, at most ``I_PROJ``; a live lane still
changing on the last one is flagged over too. Lanes that are not live
keep iterating as long as the others do, so their result depends on the
batch, as in the JAX ``while_loop``.

A CUDA tensor launches ``csrc/project_band.cu``: one warp a lane relaxes
it to its own stop and marks the batch's iteration count in a device word;
a second launch takes the lanes that are not live on to that count. The
host never waits. Each trip the kernel sorts the lane's valid entries on
one 64-bit key (``sort_key``), which orders them as the plain version's
stable sort does; it reads each out-neighbour row up to its first -1, as
``core/tables.py`` pads them. A CPU tensor runs ``project_band_plain``:
the same relaxation in torch ops, with the dedup as one stable sort on an
int64 (rank, pri) key, at ``I_PROJ`` fixed trips masked by a device-side
flag.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

EMPTY = 2**31 - 1  # empty band slot
PRI_RANGE = 1024
INF_PRI = PRI_RANGE - 1
WORD = 64
I_PROJ = 32  # relaxation trip cap (the JAX banded_scan's I_proj)

# kernel launches since the last reset (a plain count, read by the smoke
# run): two a call, the pair of launches that makes one projection
LAUNCHES = 0

# read lanes a block carries, one warp each; fewer when a block's entry
# tables would not fit in shared memory
PROJ_LANES = 4
# the kernel's sort key: topo rank in bits 32-62, pri in bits 22-31, the
# entry's concatenation index in bits 0-21
KEY_PRI_SHIFT = 22
KEY_RANK_SHIFT = 32
SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block can opt into

_INPUTS = ("p_ids", "p_node_min", "p_node_end", "p_min", "bw", "act",
           "out_nbrs", "node_len", "topo_rank")


def project_band(p_ids, p_node_min, p_node_end, p_min, bw, act, out_nbrs,
                 node_len, topo_rank):
    """One slice's band projection without a reach table.

    p_ids, p_node_min, p_node_end [B, Nm] (the previous band, topo-sorted,
    EMPTY pad, and its slots' minimum and end scores), p_min [B] (its
    minimum), bw [B] (this slice's bandwidth), act [B] bool (the lane is
    active this slice); the graph tables out_nbrs [N, K_out] (-1 pad),
    node_len and topo_rank [N] (ranks unique). int32 unless noted; the
    [B, Nm] inputs may be views of any strides. A slot's end score is at
    least the band's minimum (as the scan's carries are), so every pri
    lies in [0, INF_PRI), as the kernel's sort key needs.

    Returns (ids [B, Nm] int32, topo-sorted with EMPTY pad; over [B]
    bool). On the card ids is a view of an [Nm, B] tensor."""
    args = (p_ids, p_node_min, p_node_end, p_min, bw, act, out_nbrs,
            node_len, topo_rank)
    B, Nm = p_ids.shape
    N, K_out = out_nbrs.shape
    i = torch.int32
    want = ((i, (B, Nm)), (i, (B, Nm)), (i, (B, Nm)), (i, (B,)), (i, (B,)),
            (torch.bool, (B,)), (i, (N, K_out)), (i, (N,)), (i, (N,)))
    for name, a, (dtype, shape) in zip(_INPUTS, args, want):
        if a.dtype != dtype or tuple(a.shape) != tuple(shape):
            raise ValueError(f"project_band: {name} must be {dtype} {shape}, "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device != p_ids.device:
            raise ValueError("project_band: inputs on different devices")
    if not 1 <= Nm <= 32:
        raise NotImplementedError(
            "project_band relaxes at most 32 node slots a lane, one a warp "
            "thread")
    if p_ids.device.type == "cpu":
        return project_band_plain(*args)
    if p_ids.device.type != "cuda":
        raise ValueError(f"project_band: unsupported device {p_ids.device}")
    return _launch(*args)


def sort_key(rank, pri, idx):
    """The kernel's sort key of an entry (int64 tensors or ints): its
    node's topo rank (< 2**31), its pri (0 to PRI_RANGE - 1) and its
    concatenation index (< 2**22: the slots, then each slot's
    out-neighbours, slot-major). Keys are unique, and their order is the
    order of a stable sort on (rank, pri) over the concatenated entries."""
    return (rank << KEY_RANK_SHIFT) | (pri << KEY_PRI_SHIFT) | idx


def project_smem(Nm: int, K_out: int, lanes: int) -> int:
    """Shared bytes of a ``project_band`` block of ``lanes`` lanes: an
    int64 key and two int32 fields (id, outp) of the E = Nm * (1 + K_out)
    entries, and four [Nm] slot tables a lane (csrc/project_band.cu)."""
    return lanes * (16 * Nm * (1 + K_out) + 16 * Nm)


def project_lanes(Nm: int, K_out: int) -> int:
    """Lanes a ``project_band`` block carries: PROJ_LANES, halved until the
    block's tables fit in shared memory. Raises NotImplementedError, naming
    the limit, where one lane's do not (past out-degree 452 at Nm=32)."""
    LB = PROJ_LANES
    while LB > 1 and project_smem(Nm, K_out, LB) > SMEM_LIMIT:
        LB //= 2
    if project_smem(Nm, K_out, LB) > SMEM_LIMIT:
        raise NotImplementedError(
            f"project_band: one lane's entries at out-degree {K_out}, "
            f"Nm={Nm} take {project_smem(Nm, K_out, 1)} bytes of shared "
            f"memory, past the {SMEM_LIMIT} a block holds")
    return LB


def _launch(p_ids, p_node_min, p_node_end, p_min, bw, act, out_nbrs,
            node_len, topo_rank):
    global LAUNCHES
    B, Nm = p_ids.shape
    N, K_out = out_nbrs.shape
    LB = project_lanes(Nm, K_out)
    dev = p_ids.device
    i32_ = torch.int32
    # the [B] vectors are read as they lie; the [B, Nm] ones by strides
    p_min, bw, act = (a.contiguous() for a in (p_min, bw, act))
    out_nbrs, node_len, topo_rank = (
        a.contiguous() for a in (out_nbrs, node_len, topo_rank))
    ids = torch.empty((Nm, B), dtype=i32_, device=dev)
    over = torch.empty((B,), dtype=torch.bool, device=dev)
    # the state a lane that is not live takes into the second launch
    pri = torch.empty((Nm, B), dtype=i32_, device=dev)
    outp = torch.empty((Nm, B), dtype=i32_, device=dev)
    stop = torch.empty((B,), dtype=i32_, device=dev)
    trips = torch.empty((1,), dtype=i32_, device=dev)
    lib = _build.library("project_band")
    fn = lib.ga_project_band
    fn.restype = ctypes.c_int
    ptrs = (p_ids, p_node_min, p_node_end, p_min, bw, act, out_nbrs, node_len,
            topo_rank, ids, over, pri, outp, stop, trips)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 12 + [
        ctypes.c_void_p
    ]
    st = [p_ids.stride(0), p_ids.stride(1), p_node_min.stride(0),
          p_node_min.stride(1), p_node_end.stride(0), p_node_end.stride(1)]
    smem = project_smem(Nm, K_out, LB)
    err = fn(*[a.data_ptr() for a in ptrs], *st, Nm, B, K_out, I_PROJ, LB,
             smem, _build.stream_handle(dev))
    _build.check(err, "project_band")
    LAUNCHES += 2  # mode 0 and mode 1
    return ids.T, over


def project_band_plain(p_ids, p_node_min, p_node_end, p_min, bw, act,
                       out_nbrs, node_len, topo_rank, *,
                       trip_log: list | None = None):
    """``project_band`` in torch ops ([B, Nm] layout, as the JAX code).

    trip_log: if a list, each trip appends (valid entries [B], needed [B]
    bool): needed marks the lanes whose state was not yet a fixpoint, the
    trips the kernel runs."""
    B, Nm = p_ids.shape
    N, K_out = out_nbrs.shape
    dev = p_ids.device
    ew = bw + WORD
    valid_slot = p_ids < EMPTY
    qualified = valid_slot & (p_node_min <= (p_min + bw)[:, None])
    ids = torch.where(qualified, p_ids, EMPTY)
    pri = torch.where(qualified, 0, INF_PRI).to(torch.int32)
    seed_exp = qualified & (p_node_end <= (p_min + ew)[:, None])
    outp = torch.where(seed_exp, p_node_end - p_min[:, None] + 1,
                       INF_PRI).to(torch.int32)
    over = torch.zeros(B, dtype=torch.bool, device=dev)
    changed_l = torch.ones(B, dtype=torch.bool, device=dev)
    fixed = torch.zeros(B, dtype=torch.bool, device=dev)
    first_col = torch.ones((B, 1), dtype=torch.bool, device=dev)
    for _ in range(I_PROJ):
        run = changed_l.any()  # the while_loop's condition, on the device
        if dev.type == "cpu" and not bool(run):
            break  # the remaining trips would be masked out
        live_ids = ids < EMPTY
        cand_id = torch.where(
            live_ids[:, :, None], out_nbrs[ids.clamp(0, N - 1)], -1
        )  # [B, Nm, K_out]
        cand_valid = (live_ids[:, :, None] & (cand_id >= 0)
                      & (outp[:, :, None] <= ew[:, None, None]))
        cand_id = torch.where(cand_valid, cand_id, EMPTY).reshape(B, -1)
        cand_pri = torch.where(cand_valid, outp[:, :, None],
                               INF_PRI).reshape(B, -1)
        all_id = torch.cat([ids, cand_id], dim=1)  # [B, E]
        all_pri = torch.cat([pri, cand_pri], dim=1)
        safe = all_id.clamp(0, N - 1)
        seg_valid = all_id < EMPTY
        all_len = torch.where(seg_valid, node_len[safe], 0)
        cand_outp = torch.clamp(all_pri[:, Nm:] + all_len[:, Nm:],
                                max=INF_PRI)
        all_outp = torch.cat([outp, cand_outp], dim=1)
        valid_e = seg_valid & (all_pri < INF_PRI)
        # per-node minimum and rank order in one stable sort: a node's
        # entries share its (unique) rank, so they sort together by pri,
        # the first of equals in concatenation order (JAX's argmax)
        key = torch.where(
            valid_e, topo_rank[safe].to(torch.int64) * PRI_RANGE + all_pri,
            torch.iinfo(torch.int64).max,
        )
        key_s, perm = torch.sort(key, dim=1, stable=True)
        id_s = all_id.gather(1, perm)
        first = torch.cat([first_col, id_s[:, 1:] != id_s[:, :-1]], dim=1) & (
            key_s < torch.iinfo(torch.int64).max)
        cnt = first.cumsum(1, dtype=torch.int32)
        n_over = over | (cnt[:, -1] > Nm)
        pos = torch.where(first, cnt - 1, Nm).clamp(max=Nm).long()

        def place(vals, fill):
            out = torch.full((B, Nm + 1), fill, dtype=torch.int32, device=dev)
            out.scatter_(1, pos, torch.where(first, vals.gather(1, perm),
                                             fill))
            return out[:, :Nm]

        n_ids = place(all_id, EMPTY)
        n_pri = place(all_pri, INF_PRI)
        n_outp = place(all_outp, INF_PRI)
        raw_changed = ((n_ids != ids) | (n_pri != pri)).any(1)
        n_changed = raw_changed & act & ~n_over
        if trip_log is not None:
            trip_log.append((valid_e.sum(1), run & ~fixed))
            fixed = fixed | (run & ~raw_changed)
        ids = torch.where(run, n_ids, ids)
        pri = torch.where(run, n_pri, pri)
        outp = torch.where(run, n_outp, outp)
        over = torch.where(run, n_over, over)
        changed_l = torch.where(run, n_changed, changed_l)
    return ids, over | changed_l
