"""Banded seeded slice scan on torch tensors.

Port of ``graphaligner_tpu/core/engine_banded.py::banded_scan``: a batch of
(read, seed) extension problems, one per lane (or several back to back in
segmented lanes), advanced slice by slice with static capacities — an
[Nm]-slot node band and a [Cm]-cell cell array per lane. Each slice:

- projects the band from the previous slice through the precomputed reach
  table (one gather, one stable sort, a first-of-run dedup);
- matches the new band against the previous one and packs the per-slot
  predecessor tables (``pred_tab``, ``pred_prev``);
- builds the slice's Eq words and the per-cell metadata (the
  ``layout_parallel`` pass, with direct gathers instead of one-hot sums);
- runs the cell pass through kernel K1 (``ops.banded_cell``) and repeats it
  to a bounded fixpoint for lanes whose band has a back edge;
- records the per-slice outputs and the packed control word.

The JAX scan is a ``lax.scan``; here it is a Python loop over slices. As
there, every slice of the compiled capacity ``S_max`` runs for every lane
and inactive lanes are masked, so every output equals the JAX one. All
arrays keep the batch as the last axis ([Nm, B], [Cm, B], [7, Cm, B]).
Not ported: the XLA cell pass (the port always takes layout_parallel + K1)
and the pairwise projection (a graph needs a reach table).
"""

from __future__ import annotations

import torch

from ..ops.banded_cell import banded_cell
from ..ops.wordops import M32, i32
from .params import WORD_SIZE
from .tables import EMPTY, INF, INF_PRI, I32MAX, DeviceTables

_EMPTY = int(EMPTY)
_INF = int(INF)
_INF_PRI = int(INF_PRI)
_I32MAX = int(I32MAX)


def _i32t(x, device):
    return torch.as_tensor(x, device=device).to(torch.int32)


def banded_scan(
    dt: DeviceTables,
    read_codes,  # [B, S_max*64] uint8 (N-padded)
    seq_len,  # [B] int32 padded sequence length (num_slices*64)
    num_steps,  # [B] int32 slices to compute this round
    start_slice,  # [B] int32 global index of this round's first slice
    bandwidth,  # [S_max, B] int32
    init_ids,  # [B, Nm] int32 (topo-rank sorted, EMPTY pad)
    init_cell_send,  # [B, Cm] int32
    init_node_min,  # [B, Nm] int32
    init_node_end,  # [B, Nm] int32
    init_min,  # [B] int32
    *,
    S_max: int,
    Nm: int,
    Cm: int,
    P_fix: int = 16,
    seg=None,
    tie8: bool = False,
):
    """Returns the dict of ``graphaligner_tpu``'s banded_scan (same keys,
    shapes and values) as tensors on ``dt.device``.

    seg: optional segmented-lane tables (active, first_slice, seq_len,
    reset_node, reset_len), each [S_max, B] int32: a lane then holds
    several problems back to back, a step with reset_node >= 0 restarts
    the carry from that seed node, and the per-lane scalars are ignored.
    Read codes must then be pre-shifted so step t's rows sit at
    read_codes[:, t*64:(t+1)*64]."""
    dev = dt.device
    K_in = dt.in_nbrs.shape[1]
    if Nm > 32 or K_in > 5:
        raise NotImplementedError(
            "banded scan beyond the cell kernel's packing (Nm <= 32, "
            "K_in <= 5) is not yet ported"
        )
    N_nodes = dt.num_nodes
    read_codes = torch.as_tensor(read_codes, device=dev)
    B = read_codes.shape[0]
    segmented = seg is not None
    seq_len = _i32t(seq_len, dev)
    num_steps = _i32t(num_steps, dev)
    start_slice = _i32t(start_slice, dev)
    bandwidth = _i32t(bandwidth, dev)
    init_min = _i32t(init_min, dev)
    if segmented:
        seg_active, seg_first, seg_slen, seg_rnode, seg_rlen = (
            _i32t(s, dev) for s in seg
        )
    iota_nm = torch.arange(Nm, dtype=torch.int32, device=dev)
    iota_cm = torch.arange(Cm, dtype=torch.int32, device=dev)
    slot0 = (iota_nm == 0)[:, None]
    # a fresh seed's slot scores: 0 on slot 0, INF elsewhere
    seed_score = torch.where(slot0, 0, iota_nm[:, None] * 0 + _INF)
    w32 = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, device=dev
    )
    g5 = torch.arange(5, dtype=torch.int32, device=dev)
    rc_all = read_codes.to(torch.int64)
    L_codes = rc_all.shape[1]
    vb = 0
    for k in range(K_in):
        vb |= 1 << (5 + 6 * k)
    inf_buf = torch.stack([
        torch.full((Nm, B), -1, dtype=torch.int32, device=dev),
        torch.full((Nm, B), -1, dtype=torch.int32, device=dev),
        torch.zeros((Nm, B), dtype=torch.int32, device=dev),
        torch.zeros((Nm, B), dtype=torch.int32, device=dev),
        torch.full((Nm, B), _INF, dtype=torch.int32, device=dev),
        torch.full((Nm, B), _INF + WORD_SIZE, dtype=torch.int32, device=dev),
        torch.zeros((Nm, B), dtype=torch.int32, device=dev),
    ])

    def gather_node(table, ids, fill):
        out = table[ids.clamp(0, N_nodes - 1).long()]
        return torch.where(ids < _EMPTY, out, fill)

    def project_band_reach(p_ids_bn, p_nmin_bn, p_nend_bn, p_min, bw):
        """Precomputed-reach projection (core/reach.py): band membership is
        m s.t. some qualified seed s has outp0(s) + d*(s, m) <= ew."""
        ew = bw + WORD_SIZE
        valid_slot = p_ids_bn < _EMPTY
        qualified = valid_slot & (p_nmin_bn <= (p_min + bw)[:, None])
        outp0 = torch.where(
            qualified & (p_nend_bn <= (p_min + ew)[:, None]),
            p_nend_bn - p_min[:, None] + 1,
            _INF_PRI,
        )
        g = dt.reach[:, p_ids_bn.clamp(0, N_nodes - 1).long()]  # [2,B,Nm,K]
        rid, w1 = g[0], g[1]
        rd = w1 & 1023
        is_self = rd == 1023
        valid = (
            qualified[:, :, None]
            & (rid >= 0)
            & (is_self | ((outp0[:, :, None] + rd) <= ew[:, None, None]))
        )
        key = torch.where(valid, w1, _I32MAX).reshape(B, -1)
        ids_f = torch.where(valid, rid, _EMPTY).reshape(B, -1)
        key_s, perm = torch.sort(key, dim=1, stable=True)
        id_s = ids_f.gather(1, perm)
        first = torch.cat(
            [torch.ones((B, 1), dtype=torch.bool, device=dev),
             id_s[:, 1:] != id_s[:, :-1]], dim=1,
        ) & (key_s < _I32MAX)
        cnt = first.to(torch.int32).cumsum(1, dtype=torch.int32)
        over = cnt[:, -1] > Nm
        pos = torch.where(first, cnt - 1, Nm).clamp(max=Nm).long()
        out = torch.full((B, Nm + 1), _EMPTY, dtype=torch.int32, device=dev)
        out.scatter_(1, pos, torch.where(first, id_s, _EMPTY))
        return out[:, :Nm], over

    S = S_max
    nm_pack = torch.empty((S, 6, Nm, B), dtype=torch.int32, device=dev)
    ctrl_pack = torch.empty((S, B), dtype=torch.int32, device=dev)
    cols_out = torch.empty((S, 7, Cm, B), dtype=torch.int32, device=dev)

    p_ids = _i32t(init_ids, dev).T.contiguous()
    p_cell_send = _i32t(init_cell_send, dev).T.contiguous()
    p_node_min = _i32t(init_node_min, dev).T.contiguous()
    p_node_end = _i32t(init_node_end, dev).T.contiguous()
    p_min = init_min
    for t in range(S):
        bw = bandwidth[t]
        if segmented:
            active = seg_active[t] == 1
            first_slice = seg_first[t] == 1
            seq_len_v = seg_slen[t]
            # segment start: restart the carry from the seed node
            resetting = seg_rnode[t] >= 0
            rnode = torch.where(resetting, seg_rnode[t], 0)
            rm = resetting[None, :]
            p_ids = torch.where(
                rm, torch.where(slot0, rnode[None, :], _EMPTY), p_ids
            )
            p_cell_send = torch.where(
                rm & (iota_cm[:, None] < seg_rlen[t][None, :]), 0,
                torch.where(rm, _INF, p_cell_send),
            )
            p_node_min = torch.where(rm, seed_score, p_node_min)
            p_node_end = torch.where(rm, seed_score, p_node_end)
            p_min = torch.where(resetting, 0, p_min)
        else:
            active = t < num_steps
            g_slice = start_slice + t
            first_slice = g_slice == 0
            seq_len_v = seq_len

        ids_bn, proj_over = project_band_reach(
            p_ids.T, p_node_min.T, p_node_end.T, p_min, bw
        )
        ids = ids_bn.T.contiguous()  # [Nm, B]
        valid_slot = ids < _EMPTY

        # ---- per-slot tables ([Nm, B])
        safe = ids.clamp(0, N_nodes - 1).long()
        lens = torch.where(valid_slot, dt.node_len[safe], 0)
        starts_tab = torch.where(valid_slot, dt.node_start[safe], 0)
        nbs = dt.in_nbrs[safe]  # [Nm, B, K_in]
        c_used = lens.sum(0, dtype=torch.int32)
        cell_over = c_used > Cm

        # ---- previous-band matching
        p_valid = p_ids < _EMPTY
        same = (
            (ids[:, None, :] == p_ids[None, :, :])
            & valid_slot[:, None, :]
            & p_valid[None, :, :]
        )  # [Nm, Nm_prev, B]
        node_in_prev = same.any(1)
        prev_slot = same.to(torch.int8).argmax(1)
        p_lens = gather_node(dt.node_len, p_ids, 0)
        p_offsets = p_lens.cumsum(0, dtype=torch.int32) - p_lens
        prev_base = p_offsets.gather(0, prev_slot)

        # ---- in-neighbor classification per slot
        any_banded = torch.zeros((Nm, B), dtype=torch.bool, device=dev)
        slot_pseudo = torch.full((Nm, B), _INF, dtype=torch.int32, device=dev)
        pred_tab = torch.zeros((Nm, B), dtype=torch.int32, device=dev)
        pred_prev = torch.zeros((Nm, B), dtype=torch.int32, device=dev)
        for k in range(K_in):
            nb_k = torch.where(valid_slot, nbs[:, :, k], -1)
            nbv = (nb_k >= 0) & valid_slot
            eq_cur = (nb_k[:, None, :] == ids[None, :, :]) & nbv[:, None, :]
            in_cur_k = eq_cur.any(1)
            cur_slot_k = eq_cur.to(torch.int8).argmax(1).to(torch.int32)
            eq_prev = (
                (nb_k[:, None, :] == p_ids[None, :, :])
                & nbv[:, None, :]
                & p_valid[None, :, :]
            )
            in_prev_k = eq_prev.any(1)
            prev_slot_k = eq_prev.to(torch.int8).argmax(1)
            pe_k = torch.where(
                in_prev_k, p_node_end.gather(0, prev_slot_k), _INF
            )
            slot_pseudo = torch.minimum(
                slot_pseudo, torch.where(in_prev_k & ~in_cur_k, pe_k, _INF)
            )
            any_banded = any_banded | in_cur_k | in_prev_k
            pred_tab = pred_tab | (
                (cur_slot_k | (in_cur_k.to(torch.int32) << 5)) << (6 * k)
            )
            # PREVIOUS-band slot per pred: the walk's boundary diagonal
            # reads preds that fell out of the current band
            pred_prev = pred_prev | (
                (prev_slot_k.to(torch.int32) | (in_prev_k.to(torch.int32) << 5))
                << (6 * k)
            )
        band_source = ~any_banded & valid_slot
        src_noprev_slot = band_source & ~node_in_prev
        src_sm_slot = band_source & node_in_prev & first_slice[None, :]

        # ---- per-slice Eq words for the 5 graph codes ([5, B])
        if segmented:
            rc = rc_all[:, t * WORD_SIZE:(t + 1) * WORD_SIZE]
        else:
            rc_base = (g_slice * WORD_SIZE).clamp(0, L_codes - WORD_SIZE)
            rc = rc_all.gather(
                1,
                rc_base.long()[:, None]
                + torch.arange(WORD_SIZE, device=dev)[None, :],
            )
        bits = (dt.bits_lut[rc][:, :, None] >> g5) & 1  # [B, 64, 5]
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
        pos = (rd(starts_tab) + off).clamp(0, dt.seq_codes.shape[0] - 1)
        code = torch.where(vc, dt.seq_codes[pos.long()], 4)
        old_idx = (rd(prev_base) + off).clamp(0, Cm - 1)
        oe = torch.where(
            inprev & vc, p_cell_send.gather(0, old_idx.long()), _INF
        )
        ps = torch.where(st, rd(slot_pseudo), _INF)
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
        rp = rd(pred_tab)
        m2 = torch.where(st, rp, rp & ~vb)
        back_edge = torch.zeros(B, dtype=torch.bool, device=dev)
        for k in range(K_in):
            pslot_k = (rp >> (6 * k)) & 31
            pvalid_k = st & (((rp >> (5 + 6 * k)) & 1) == 1)
            back_edge = back_edge | (pvalid_k & (pslot_k >= slot)).any(0)

        def cell_pass(buf_init):
            return banded_cell(
                m1, m2.contiguous(), oe.contiguous(), ps.contiguous(),
                eq_lo_tab.contiguous(), eq_hi_tab.contiguous(),
                seq_len_v[None, :].contiguous(), buf_init, K_in=K_in,
            )

        cols, buf, nmin = cell_pass(inf_buf)
        # bounded fixpoint for cyclic bands (back edge = an in-band
        # predecessor at a topo slot >= the node's own)
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
        min_score = torch.where(valid_slot, nmin, _INF).min(0).values
        overflow = proj_over | cell_over | fix_fail
        am2 = active[None, :]
        nm_pack[t] = torch.stack([
            torch.where(am2, ids, _EMPTY),
            torch.where(am2, nmin, _INF),
            torch.where(am2, node_end, _INF),
            torch.where(am2, lens, 0),
            torch.where(am2, pred_tab, 0),
            torch.where(am2, pred_prev, 0),
        ])
        # packed control word: min-score delta (bits 0-6), band cells
        # (bits 7-29), overflow (bit 30)
        ctrl_pack[t] = (
            torch.where(active, (min_score - p_min).clamp(0, 127), 0)
            | (torch.where(active, c_used.clamp(max=Cm), 0) << 7)
            | ((overflow & active).to(torch.int32) << 30)
        )
        cols_out[t] = cols
        p_ids = torch.where(am2, ids, p_ids)
        p_cell_send = torch.where(am2, cols[5], p_cell_send)
        p_node_min = torch.where(am2, nmin, p_node_min)
        p_node_end = torch.where(am2, node_end, p_node_end)
        p_min = torch.where(active, min_score, p_min)

    return _finish_outputs(
        nm_pack, ctrl_pack, cols_out, rc_all, init_min, num_steps,
        (seg_active, seg_rnode) if segmented else None, tie8, Nm,
    )


def _finish_outputs(nm_pack, ctrl_pack, cols, read_codes, init_min,
                    num_steps, seg, tie8, Nm):
    S, B = ctrl_pack.shape
    dev = ctrl_pack.device
    band_ids = nm_pack[:, 0]
    node_min = nm_pack[:, 1]
    node_end = nm_pack[:, 2]
    # unpack the control word and rebuild absolute per-slice minima from
    # the delta stream (mirrored on the host by batch_align._unpack_control)
    delta = ctrl_pack & 127
    num_cells = (ctrl_pack >> 7) & 0x7FFFFF
    overflow = ((ctrl_pack >> 30) & 1) != 0
    cs = delta.cumsum(0, dtype=torch.int32)
    iota_sb = torch.arange(S, dtype=torch.int32, device=dev)[:, None].expand(
        S, B
    )
    if seg is not None:
        seg_active, seg_rnode = seg
        reset = seg_rnode >= 0
        last_reset = torch.cummax(
            torch.where(reset, iota_sb, -1), dim=0
        ).values
        prev_cs = torch.cat(
            [torch.zeros((1, B), dtype=torch.int32, device=dev), cs[:-1]]
        )
        base = torch.where(
            last_reset >= 0,
            -prev_cs.gather(0, last_reset.clamp(min=0).long()),
            init_min[None, :],
        )
        active_m = seg_active == 1
    else:
        base = init_min[None, :]
        active_m = iota_sb < num_steps[None, :]
    min_score = torch.where(active_m, cs + base, _INF)
    # packed per-slot score deltas for the host band-order replay
    nmin_d = (node_min - min_score[:, None, :]).clamp(0, 32767)
    nend_d = (node_end - min_score[:, None, :]).clamp(0, 32767)
    if tie8:
        t16 = nmin_d.clamp(max=255) | (nend_d.clamp(max=255) << 8)
        tie_pack = torch.where(t16 >= 32768, t16 - 65536, t16).to(torch.int16)
    else:
        tie_pack = nmin_d | (nend_d << 16)
    # subsampled band-id hash (band_hash_np / ga_native.cpp ga_band_orders_core):
    # uint32 arithmetic in int64, the multiply split so nothing overflows
    w = ((torch.arange(Nm, dtype=torch.int64, device=dev) + 1)
         * 2654435761) & M32
    a = band_ids[::8].to(torch.int64) & M32  # [S/8, Nm, B]
    w_lo = (w & 0xFFFF)[None, :, None]
    w_hi = (w >> 16)[None, :, None]
    prod = (a * w_lo + (((a * w_hi) & 0xFFFF) << 16)) & M32
    ids_hash = i32(prod.sum(1))
    return {
        "tie16": tie_pack,
        "ids_sub": ids_hash,
        "band_ids": band_ids,
        "node_min": node_min,
        "node_end": node_end,
        "min_score": min_score,
        "num_cells": num_cells,
        "overflow": overflow,
        "control": ctrl_pack,
        "cols": cols,  # [S, 7, Cm, B]: vp_lo vp_hi vn_lo vn_hi sbs send e
        "sends": cols[:, 5],
        "lens_tab": nm_pack[:, 3],
        "pred_tab": nm_pack[:, 4],
        "pred_prev": nm_pack[:, 5],
        "codes": read_codes.to(torch.uint8)
        .reshape(B, -1, WORD_SIZE)
        .permute(1, 2, 0)
        .contiguous(),  # [S, 64, B]
    }
