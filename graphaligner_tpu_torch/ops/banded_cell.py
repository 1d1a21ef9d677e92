"""Banded slice cell pass (kernel K1), fused with its slice's metadata
pass: wrapper and plain versions.

``slice_cells`` computes one slice of ``graphaligner_tpu``'s banded scan
(``core/engine_banded.py::banded_scan``) after the band projection: from
the projected band ``ids`` and the previous slice's carries it builds the
per-slot tables (lengths, previous-band matching, in-neighbour
classification, the packed predecessor tables), the lane's Eq words from
its 64 read codes and the per-cell metadata, runs the cell pass (the
work of ``graphaligner_tpu.ops.pallas.banded_cell.banded_cell_kernel``),
repeats it to a bounded fixpoint on lanes whose band has a back edge, and
returns the slice's outputs and the next carries.

A CUDA tensor launches ``csrc/banded_cell.cu`` (one launch a slice, the
metadata and every cell pass on chip); a CPU tensor runs
``slice_cells_plain``, the same computation in plain torch ops, whose cell
pass is ``banded_cell_plain``, the twin of the Pallas kernel.

In-degree: up to 5 in-neighbours the kernel is the Pallas kernel's twin;
past 5 it computes what the JAX package runs there, the XLA cell pass
(``engine_banded.py::cell_pass_xla``), which reads each in-neighbour's
slot directly, at any in-degree. The per-slot predecessor tables then
take ``pred_words(K_in)`` int32 planes: plane p holds in-neighbours 5p to
5p + 4, each in a 6-bit field (slot | valid << 5) at bit 6 (k - 5p), bits
30-31 clear. One plane is the JAX package's word; past 5 in-neighbours the
JAX word keeps only the first five and two bits of the sixth, and nothing
reads it there (its walk reads bands and columns). A 6-bit slot (Nm = 64)
would take 7-bit fields, 4 a plane, in the same plane layout. On the card
the wide route writes the planes out and keeps in shared memory only a
hash table of the bands' node ids and each slot's in-band predecessors as
a list of bytes (``slice_smem``), so its shared bytes do not grow with the
in-degree; it reads ``in_nbrs`` rows up to their first -1, as
``core/tables.py`` pads them. Where one lane's tables do not fit a block
(only at a Cm past any tier), the launch raises ``NotImplementedError``
naming the in-degree, Cm, Nm and bytes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .wordops import M32, i32, merge_slices, myers_advance, u32

INF = 1 << 20
EMPTY = 2**31 - 1  # empty band slot
WORD = 64
PRED_PER_WORD = 5  # 6-bit (slot | valid << 5) fields in an int32 pred plane


def pred_words(K_in: int) -> int:
    """int32 planes of a slot's predecessor table at in-degree K_in."""
    return -(-K_in // PRED_PER_WORD)


def pred_field(planes, k):
    """In-neighbour k's 6-bit field of a pred table given as a sequence of
    planes (slot in bits 0-4, valid in bit 5)."""
    return (planes[k // PRED_PER_WORD] >> (6 * (k % PRED_PER_WORD))) & 63


# kernel launches since the last reset (plain counts, read by the smoke
# run): the narrow route (K_in <= 5) and the wide one (past 5)
LAUNCHES = 0
LAUNCHES_WIDE = 0
NARROW_K_IN = PRED_PER_WORD  # the widest in-degree of one pred word

# read lanes a block carries (one warp of slot threads each): the narrow
# route's SLICE_LANES; the wide route's WIDE_LANES, fewer, so that fewer
# lanes share the warp of the serial cell pass, whose node starts merge
# many predecessors, and more blocks fill the SMs (chosen on the card by
# compare_k1_proj.py --lanes); halved when a block's tables would not fit
SLICE_LANES = 8
WIDE_LANES = 1
HT_SIZE = 128  # the wide route's hash buckets a lane (csrc/banded_cell.cu)
SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block can opt into

_INPUTS = ("ids", "proj_over", "p_ids", "p_node_min", "p_node_end",
           "p_cell_send", "p_min", "active", "first_slice", "seq_len",
           "read_codes", "win", "node_len", "node_start", "in_nbrs",
           "seq_codes", "bits_lut")


def slice_cells(ids, proj_over, p_ids, p_node_min, p_node_end, p_cell_send,
                p_min, active, first_slice, seq_len, read_codes, win,
                node_len, node_start, in_nbrs, seq_codes, bits_lut, *,
                P_fix: int = 16):
    """One banded slice after its projection.

    ids [Nm, B] (the projected band, topo-sorted, EMPTY pad), proj_over
    [B] bool; the carries p_ids, p_node_min, p_node_end [Nm, B],
    p_cell_send [Cm, B], p_min [B]; this step's active and first_slice [B]
    bool, seq_len [B], read_codes [B, L] uint8 and win [B] (the slice whose
    64 codes give the Eq words, read at clamp(win * 64, 0, L - 64)); the
    graph tables node_len, node_start [N], in_nbrs [N, K_in], seq_codes
    [BP] and bits_lut [R]. int32 unless noted.

    Returns new tensors: cols [7, Cm, B], nm [4 + 2P, Nm, B] (ids, nmin,
    node_end, lens, the P = pred_words(K_in) planes of pred_tab, then those
    of pred_prev, each masked by active), ctrl [B]
    (min-score delta | cells << 7 | overflow << 30), and the next carries
    p_ids, p_cell_send, p_node_min, p_node_end, p_min."""
    args = (ids, proj_over, p_ids, p_node_min, p_node_end, p_cell_send,
            p_min, active, first_slice, seq_len, read_codes, win, node_len,
            node_start, in_nbrs, seq_codes, bits_lut)
    Nm, B = ids.shape
    Cm = p_cell_send.shape[0]
    N, K_in = in_nbrs.shape
    i, b = torch.int32, torch.bool
    want = (
        (i, (Nm, B)), (b, (B,)), (i, (Nm, B)), (i, (Nm, B)), (i, (Nm, B)),
        (i, (Cm, B)), (i, (B,)), (b, (B,)), (b, (B,)), (i, (B,)),
        (torch.uint8, (B, read_codes.shape[-1])), (i, (B,)), (i, (N,)),
        (i, (N,)), (i, (N, K_in)), (i, seq_codes.shape[-1:]),
        (i, bits_lut.shape[-1:]),
    )
    for name, a, (dtype, shape) in zip(_INPUTS, args, want):
        if a.dtype != dtype or tuple(a.shape) != tuple(shape):
            raise ValueError(f"slice_cells: {name} must be {dtype} {shape}, "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device != ids.device:
            raise ValueError("slice_cells: inputs on different devices")
    if K_in < 1 or Nm > 32 or read_codes.shape[1] < WORD:
        raise NotImplementedError(
            "slice_cells packs Nm <= 32 slots and at least one predecessor "
            "column, over at least one slice of read codes"
        )
    if ids.device.type == "cpu":
        return slice_cells_plain(*args, P_fix=P_fix)
    if ids.device.type != "cuda":
        raise ValueError(f"slice_cells: unsupported device {ids.device}")
    return _launch(*[a.contiguous() for a in args], P_fix=P_fix)


def slice_smem(Nm: int, Cm: int, lanes: int, K_in: int = 1) -> int:
    """Shared bytes of a ``slice_cells`` block of ``lanes`` lanes: 21
    [Nm] slot tables (the node-end buffer's 7 among them), 2 [Cm] cell
    tables and 12 words a lane; on the wide route (K_in past 5) also a
    hash table of 2 HT_SIZE words and the in-band lists, Nm bytes a slot
    (csrc/banded_cell.cu)."""
    words = 21 * Nm + 2 * Cm + 12
    if K_in <= NARROW_K_IN:
        return 4 * lanes * words
    return lanes * (4 * (words + 2 * HT_SIZE) + Nm * Nm)


def slice_lanes(Nm: int, Cm: int, K_in: int) -> int:
    """Lanes a ``slice_cells`` block carries: SLICE_LANES (WIDE_LANES past
    5 in-neighbours), halved until the block's tables fit in shared
    memory. Raises NotImplementedError, naming the limit, where one lane's
    do not."""
    LB = WIDE_LANES if K_in > NARROW_K_IN else SLICE_LANES
    while LB > 1 and slice_smem(Nm, Cm, LB, K_in) > SMEM_LIMIT:
        LB //= 2
    if slice_smem(Nm, Cm, LB, K_in) > SMEM_LIMIT:
        raise NotImplementedError(
            f"slice_cells: one lane's tables at in-degree {K_in}, Cm={Cm}, "
            f"Nm={Nm} take {slice_smem(Nm, Cm, 1, K_in)} bytes of shared "
            f"memory, past the {SMEM_LIMIT} a block holds")
    return LB


def _launch(ids, proj_over, p_ids, p_node_min, p_node_end, p_cell_send,
            p_min, active, first_slice, seq_len, read_codes, win, node_len,
            node_start, in_nbrs, seq_codes, bits_lut, *, P_fix):
    global LAUNCHES, LAUNCHES_WIDE
    Nm, B = ids.shape
    Cm = p_cell_send.shape[0]
    N, K_in = in_nbrs.shape
    wide = K_in > NARROW_K_IN
    LB = slice_lanes(Nm, Cm, K_in)
    dev = ids.device
    i32_ = torch.int32
    cols = torch.empty((7, Cm, B), dtype=i32_, device=dev)
    nm = torch.empty((4 + 2 * pred_words(K_in), Nm, B), dtype=i32_,
                     device=dev)
    ctrl = torch.empty((B,), dtype=i32_, device=dev)
    o_ids = torch.empty((Nm, B), dtype=i32_, device=dev)
    o_cell_send = torch.empty((Cm, B), dtype=i32_, device=dev)
    o_node_min = torch.empty((Nm, B), dtype=i32_, device=dev)
    o_node_end = torch.empty((Nm, B), dtype=i32_, device=dev)
    o_min = torch.empty((B,), dtype=i32_, device=dev)
    ptrs = (ids, proj_over, p_ids, p_node_min, p_node_end, p_cell_send, p_min,
            active, first_slice, seq_len, read_codes, win, node_len,
            node_start, in_nbrs, seq_codes, bits_lut, cols, nm, ctrl, o_ids,
            o_cell_send, o_node_min, o_node_end, o_min)
    lib = _build.library("banded_cell")
    fn = lib.ga_slice_cells_wide if wide else lib.ga_slice_cells
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    err = fn(
        *[a.data_ptr() for a in ptrs],
        Nm, Cm, B, N, K_in, seq_codes.shape[0], read_codes.shape[1], P_fix,
        LB, slice_smem(Nm, Cm, LB, K_in), _build.stream_handle(dev),
    )
    _build.check(err, "slice_cells")
    if wide:
        LAUNCHES_WIDE += 1
    else:
        LAUNCHES += 1
    return cols, nm, ctrl, o_ids, o_cell_send, o_node_min, o_node_end, o_min


def slice_cells_plain(ids, proj_over, p_ids, p_node_min, p_node_end,
                      p_cell_send, p_min, active, first_slice, seq_len,
                      read_codes, win, node_len, node_start, in_nbrs,
                      seq_codes, bits_lut, *, P_fix: int = 16):
    """Plain torch version of ``slice_cells`` (any device): the banded
    scan's per-slice torch code as it was, with ``banded_cell_plain`` for
    each cell pass and the bounded fixpoint as a loop over whole passes
    while any back-edge lane still changes."""
    Nm, B = ids.shape
    Cm = p_cell_send.shape[0]
    N_nodes, K_in = in_nbrs.shape
    dev = ids.device
    iota_cm = torch.arange(Cm, dtype=torch.int32, device=dev)
    valid_slot = ids < EMPTY

    def gather_node(table, x, fill):
        out = table[x.clamp(0, N_nodes - 1).long()]
        return torch.where(x < EMPTY, out, fill)

    # ---- per-slot tables ([Nm, B])
    safe = ids.clamp(0, N_nodes - 1).long()
    lens = torch.where(valid_slot, node_len[safe], 0)
    starts_tab = torch.where(valid_slot, node_start[safe], 0)
    nbs = in_nbrs[safe]  # [Nm, B, K_in]
    c_used = lens.sum(0, dtype=torch.int32)
    cell_over = c_used > Cm

    # ---- previous-band matching
    p_valid = p_ids < EMPTY
    same = (
        (ids[:, None, :] == p_ids[None, :, :])
        & valid_slot[:, None, :]
        & p_valid[None, :, :]
    )  # [Nm, Nm_prev, B]
    node_in_prev = same.any(1)
    prev_slot = same.to(torch.int8).argmax(1)
    p_lens = gather_node(node_len, p_ids, 0)
    p_offsets = p_lens.cumsum(0, dtype=torch.int32) - p_lens
    prev_base = p_offsets.gather(0, prev_slot)

    # ---- in-neighbor classification per slot, every in-neighbour at once
    # ([Nm, B, K_in]: its first slot in this band and in the previous one)
    NP = pred_words(K_in)
    nb = torch.where(valid_slot[..., None], nbs, -1)
    nbv = nb >= 0
    eq_cur = (nb[:, None] == ids[None, :, :, None]) & nbv[:, None]
    in_cur = eq_cur.any(1)
    cur_slot = eq_cur.to(torch.int8).argmax(1).to(torch.int32)
    eq_prev = ((nb[:, None] == p_ids[None, :, :, None]) & nbv[:, None]
               & p_valid[None, :, :, None])
    in_prev = eq_prev.any(1)
    prev_slot = eq_prev.to(torch.int8).argmax(1)
    pe = torch.where(
        in_prev, p_node_end[..., None].expand(Nm, B, K_in).gather(0, prev_slot),
        INF)
    slot_pseudo = torch.where(in_prev & ~in_cur, pe, INF).amin(-1).clamp(
        max=INF).to(torch.int32)
    any_banded = (in_cur | in_prev).any(-1)

    def planes(slot_k, in_k):
        """The NP int32 planes of (slot | valid << 5) fields, five a plane
        (fields are disjoint, so their sum is their OR)."""
        f = slot_k.to(torch.int32) | (in_k.to(torch.int32) << 5)
        f = torch.nn.functional.pad(f, (0, NP * PRED_PER_WORD - K_in))
        sh = 6 * torch.arange(PRED_PER_WORD, dtype=torch.int32, device=dev)
        f = f.reshape(Nm, B, NP, PRED_PER_WORD) << sh
        return list(f.sum(-1, dtype=torch.int32).permute(2, 0, 1))

    # PREVIOUS-band slot per pred: the walk's boundary diagonal reads
    # preds that fell out of the current band
    pred_tab = planes(cur_slot, in_cur)
    pred_prev = planes(prev_slot, in_prev)
    band_source = ~any_banded & valid_slot
    src_noprev_slot = band_source & ~node_in_prev
    src_sm_slot = band_source & node_in_prev & first_slice[None, :]

    # ---- the slice's Eq words for the 5 graph codes ([5, B])
    L_codes = read_codes.shape[1]
    rc_base = (win * WORD).clamp(0, L_codes - WORD)
    rc = read_codes.to(torch.int64).gather(
        1, rc_base.long()[:, None] + torch.arange(WORD, device=dev)[None, :]
    )
    g5 = torch.arange(5, dtype=torch.int32, device=dev)
    w32 = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, device=dev
    )
    bits = (bits_lut[rc][:, :, None] >> g5) & 1  # [B, 64, 5]
    eq_lo_tab = i32((bits[:, :32].to(torch.int64) * w32[:, None]).sum(1).T)
    eq_hi_tab = i32((bits[:, 32:].to(torch.int64) * w32[:, None]).sum(1).T)

    # ---- per-cell metadata (layout_parallel; no sequential dependency)
    cum_end = lens.cumsum(0, dtype=torch.int32)
    slot = (
        (iota_cm[:, None, None] >= cum_end[None]) & (lens > 0)[None]
    ).sum(1).clamp(max=Nm - 1)  # [Cm, B] int64

    def rd(tab):
        return tab.gather(0, slot)

    base = rd(cum_end - lens)
    off = iota_cm[:, None] - base
    len_s = rd(lens)
    vc = (iota_cm[:, None] < c_used[None, :]) & (len_s > 0)
    st = (off == 0) & vc
    en = (off == len_s - 1) & vc
    inprev = rd(node_in_prev.to(torch.int32)) == 1
    pos = (rd(starts_tab) + off).clamp(0, seq_codes.shape[0] - 1)
    code = torch.where(vc, seq_codes[pos.long()], 4)
    old_idx = (rd(prev_base) + off).clamp(0, Cm - 1)
    oe = torch.where(inprev & vc, p_cell_send.gather(0, old_idx.long()), INF)
    ps = torch.where(st, rd(slot_pseudo), INF)
    srcnp = st & (rd(src_noprev_slot.to(torch.int32)) == 1)
    srcsm = st & (rd(src_sm_slot.to(torch.int32)) == 1)
    m1 = (
        slot.to(torch.int32)
        | (st.to(torch.int32) << 8)
        | (en.to(torch.int32) << 9)
        | (vc.to(torch.int32) << 10)
        | (inprev.to(torch.int32) << 11)
        | (code << 12)
        | (srcnp.to(torch.int32) << 15)
        | (srcsm.to(torch.int32) << 16)
    )
    # meta2: each plane's valid bits gated by st, its slot bits not (as
    # the JAX package builds its word)
    m2, back_edge = [], torch.zeros(B, dtype=torch.bool, device=dev)
    rp = [rd(t) for t in pred_tab]
    for p in range(NP):
        vb = 0
        for k in range(p * PRED_PER_WORD, min(K_in, (p + 1) * PRED_PER_WORD)):
            vb |= 1 << (5 + 6 * (k % PRED_PER_WORD))
        m2.append(torch.where(st, rp[p], rp[p] & ~vb))
    m2 = torch.cat(m2)  # [NP * Cm, B]
    for k in range(K_in):
        f = pred_field(rp, k)
        pvalid_k = st & ((f >> 5) == 1)
        back_edge = back_edge | (pvalid_k & ((f & 31) >= slot)).any(0)

    def cell_pass(buf_init):
        return banded_cell_plain(
            m1, m2.contiguous(), oe.contiguous(), ps.contiguous(),
            eq_lo_tab.contiguous(), eq_hi_tab.contiguous(),
            seq_len[None, :].contiguous(), buf_init, K_in=K_in,
        )

    inf_buf = torch.tensor(
        [-1, -1, 0, 0, INF, INF + WORD, 0], dtype=torch.int32, device=dev
    )[:, None, None].expand(7, Nm, B).contiguous()
    cols, buf, nmin = cell_pass(inf_buf)
    # bounded fixpoint for cyclic bands (back edge = an in-band predecessor
    # at a topo slot >= the node's own)
    fix_fail = torch.zeros(B, dtype=torch.bool, device=dev)
    if bool(back_edge.any()):
        lane_ch = back_edge
        still = True
        it = 0
        while still and it < P_fix:
            cols1, buf1, nmin1 = cell_pass(buf)
            diff = (cols1 != cols).flatten(0, 1).any(0)
            lane_ch = diff & back_edge
            cols, buf, nmin = cols1, buf1, nmin1
            still = bool(lane_ch.any())
            it += 1
        if still:
            fix_fail = lane_ch

    node_end = buf[5]
    min_score = torch.where(valid_slot, nmin, INF).min(0).values
    overflow = proj_over | cell_over | fix_fail
    am2 = active[None, :]
    nm = torch.stack([
        torch.where(am2, ids, EMPTY),
        torch.where(am2, nmin, INF),
        torch.where(am2, node_end, INF),
        torch.where(am2, lens, 0),
        *[torch.where(am2, t, 0) for t in pred_tab + pred_prev],
    ])
    # packed control word: min-score delta (bits 0-6), band cells (bits
    # 7-29), overflow (bit 30)
    ctrl = (
        torch.where(active, (min_score - p_min).clamp(0, 127), 0)
        | (torch.where(active, c_used.clamp(max=Cm), 0) << 7)
        | ((overflow & active).to(torch.int32) << 30)
    )
    return (
        cols, nm, ctrl,
        torch.where(am2, ids, p_ids),
        torch.where(am2, cols[5], p_cell_send),
        torch.where(am2, nmin, p_node_min),
        torch.where(am2, node_end, p_node_end),
        torch.where(active, min_score, p_min),
    )


def banded_cell_plain(meta1, meta2, old_end, pseudo, eq_lo, eq_hi, seq_len,
                      buf_init, *, K_in: int):
    """One cell pass in plain torch ops (any device), with the signature
    and outputs of ``graphaligner_tpu``'s ``banded_cell_kernel``: meta1
    [Cm, B]: slot|st<<8|en<<9|vc<<10|inprev<<11|code<<12|srcnp<<15|
    srcsm<<16; meta2 [P * Cm, B], P = pred_words(K_in) planes of [Cm, B]
    (one up to K_in = 5, the kernel's word): in-neighbour k's (slot |
    valid << 5) at bit 6 (k % 5) of plane k // 5; old_end,
    pseudo [Cm, B]; eq_lo, eq_hi [5, B] (uint32 bit patterns); seq_len
    [1, B]; buf_init [7, Nm, B]. All int32. Returns (cols [7, Cm, B], buf
    [7, Nm, B], nmin [Nm, B]).

    Past K_in = 5 it is the JAX package's XLA cell pass (``cell_pass_xla``),
    which merges the same predecessors in the same order.

    Everything that does not depend on the previous cell is computed for
    all cells at once; the loop carries the column, the node-end buffer
    and the slot minima. Cells past the last valid cell of every lane only
    emit the invalid column, and a predecessor merge no lane needs at a
    cell is skipped: both are exact."""
    Cm, B = meta1.shape
    Nm = buf_init.shape[1]
    if K_in < 1 or Nm > 32:
        raise NotImplementedError(
            "banded_cell packs Nm <= 32 slots and at least one predecessor "
            "column"
        )
    NP = pred_words(K_in)
    args = (meta1, meta2, old_end, pseudo, eq_lo, eq_hi, seq_len, buf_init)
    shapes = ((Cm, B), (NP * Cm, B), (Cm, B), (Cm, B), (5, B), (5, B),
              (1, B), (7, Nm, B))
    for name, a, shape in zip(
        ("meta1", "meta2", "old_end", "pseudo", "eq_lo", "eq_hi", "seq_len",
         "buf_init"), args, shapes,
    ):
        if a.dtype != torch.int32 or tuple(a.shape) != shape:
            raise ValueError(f"banded_cell: {name} must be int32 {shape}, "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device != meta1.device:
            raise ValueError("banded_cell: inputs on different devices")
    dev = meta1.device
    lanes = torch.arange(B, device=dev)
    m1 = meta1.to(torch.int64)
    slot = m1 & 0xFF
    st = ((m1 >> 8) & 1) == 1
    en = ((m1 >> 9) & 1) == 1
    vc = ((m1 >> 10) & 1) == 1
    inprev = ((m1 >> 11) & 1) == 1
    code = (m1 >> 12) & 7
    srcnp = ((m1 >> 15) & 1) == 1
    srcsm = ((m1 >> 16) & 1) == 1
    oe = old_end.to(torch.int64)
    ps = pseudo.to(torch.int64)
    zeros3 = torch.zeros((3, B), dtype=torch.int64, device=dev)
    eq_lo_c = torch.cat([u32(eq_lo), zeros3]).gather(0, code)  # [Cm, B]
    eq_hi_c = torch.cat([u32(eq_hi), zeros3]).gather(0, code)
    slen = seq_len.to(torch.int64)  # [1, B]

    # fused uniform column (boundary / pseudo / band source), all cells
    match0 = eq_lo_c & 1
    sm0 = torch.where(srcsm, 1 - match0, 1)
    sbs_b = torch.where(inprev, oe, INF)
    a_b = torch.where(inprev, oe + sm0, INF + 1)
    has_ps = ps < INF
    sbs_p = torch.where(has_ps, ps + 1, INF)
    a_p = torch.where(has_ps, ps + 1 - match0, INF + 1)
    sbs_s = torch.where(srcnp, slen + 1, INF)
    a_s = torch.where(srcnp, slen + 2, INF + 1)
    sbs_f = torch.minimum(torch.minimum(sbs_b, sbs_p), sbs_s)
    a_f = torch.minimum(torch.minimum(a_b, a_p), a_s)
    delta = a_f - sbs_f
    uni = torch.stack([
        (M32 ^ 1) | (delta == 1).to(torch.int64),
        torch.full_like(delta, M32),
        (delta == -1).to(torch.int64),
        torch.zeros_like(delta),
        sbs_f,
        a_f + 63,
        torch.zeros_like(delta),
    ])  # [7, Cm, B]

    m2 = meta2.to(torch.int64).reshape(NP, Cm, B)
    fields = [pred_field(m2, k) for k in range(K_in)]
    pslot = [f & 31 for f in fields]
    pvalid = [((f >> 5) == 1) & st for f in fields]
    # host-side schedule: the last valid cell and the merges any lane needs
    vc_any = vc.any(1).cpu()
    c_hi = int(torch.nonzero(vc_any).max()) + 1 if bool(vc_any.any()) else 0
    need = torch.stack([p.any(1) for p in pvalid], 1).cpu().tolist()

    buf = torch.cat([u32(buf_init[:4]), buf_init[4:].to(torch.int64)])
    buf = buf.reshape(7, Nm * B).clone()
    nmin = torch.full((Nm * B,), INF, dtype=torch.int64, device=dev)
    cols = torch.empty((7, Cm, B), dtype=torch.int64, device=dev)
    col = (
        torch.full((B,), M32, dtype=torch.int64, device=dev),
        torch.full((B,), M32, dtype=torch.int64, device=dev),
        torch.zeros(B, dtype=torch.int64, device=dev),
        torch.zeros(B, dtype=torch.int64, device=dev),
        torch.full((B,), INF, dtype=torch.int64, device=dev),
        torch.full((B,), INF + 64, dtype=torch.int64, device=dev),
        torch.zeros(B, dtype=torch.int64, device=dev),
    )
    inf_col = torch.tensor(
        [M32, M32, 0, 0, INF, INF + 64], dtype=torch.int64, device=dev
    )
    for c in range(c_hi):
        vp_lo, vp_hi, vn_lo, vn_hi, sbs, send, e_prev = col
        eq_lo_v, eq_hi_v = eq_lo_c[c], eq_hi_c[c]
        r_chain = torch.minimum(oe[c], sbs + 1)
        eq_g = torch.where((e_prev & 1) == 1, eq_lo_v, eq_lo_v & (M32 ^ 1))
        c_vp_lo, c_vp_hi, c_vn_lo, c_vn_hi, c_send = myers_advance(
            eq_g, eq_hi_v, vp_lo, vp_hi, vn_lo, vn_hi, send, r_chain - sbs
        )
        merged = tuple(uni[:, c])
        for k in range(K_in):
            if not need[c][k]:
                continue
            ps_k = pslot[k][c]
            ok = (ps_k < Nm).to(torch.int64)
            g = buf.gather(1, (ps_k.clamp(max=Nm - 1) * B + lanes)[None]
                           .expand(7, B)) * ok
            eq_k = torch.where((g[6] & 1) == 1, eq_lo_v, eq_lo_v & (M32 ^ 1))
            a_vp_lo, a_vp_hi, a_vn_lo, a_vn_hi, a_send = myers_advance(
                eq_k, eq_hi_v, g[0], g[1], g[2], g[3], g[5],
                torch.ones_like(g[5]),
            )
            cand = merge_slices(
                merged,
                (a_vp_lo, a_vp_hi, a_vn_lo, a_vn_hi, g[4] + 1, a_send, g[6]),
            )
            pv = pvalid[k][c]
            merged = tuple(torch.where(pv, x, y) for x, y in zip(cand, merged))
        st_c = st[c]
        chain = (c_vp_lo, c_vp_hi, c_vn_lo, c_vn_hi, r_chain, c_send)
        n = torch.where(
            vc[c],
            torch.where(st_c, torch.stack(merged[:6]), torch.stack(chain)),
            inf_col[:, None],
        )  # [6, B]
        n_e = (inprev[c] & (n[4] == oe[c]) & vc[c]).to(torch.int64) | (
            code[c] << 1
        )
        fields = torch.cat([n, n_e[None]])  # [7, B]
        cols[:, c] = fields
        has_slot = slot[c] < Nm
        tgt = slot[c].clamp(max=Nm - 1) * B + lanes
        w_end = en[c] & vc[c] & has_slot
        cur = buf.gather(1, tgt[None].expand(7, B))
        buf.scatter_(1, tgt[None].expand(7, B), torch.where(w_end, fields, cur))
        cur_min = nmin.gather(0, tgt)
        nmin.scatter_(0, tgt, torch.where(
            vc[c] & has_slot, torch.minimum(cur_min, fields[5]), cur_min
        ))
        col = tuple(fields)
    if c_hi < Cm:
        tail = torch.cat([
            inf_col[:, None, None].expand(6, Cm - c_hi, B),
            (code[c_hi:] << 1)[None],
        ])
        cols[:, c_hi:] = tail
    cols32 = torch.cat([i32(cols[:4]), cols[4:].to(torch.int32)])
    buf = buf.reshape(7, Nm, B)
    buf32 = torch.cat([i32(buf[:4]), buf[4:].to(torch.int32)])
    return cols32, buf32, nmin.reshape(Nm, B).to(torch.int32)
