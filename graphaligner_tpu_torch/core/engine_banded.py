"""Banded seeded slice scan on torch tensors.

Port of ``graphaligner_tpu/core/engine_banded.py::banded_scan``: a batch of
(read, seed) extension problems, one per lane (or several back to back in
segmented lanes), advanced slice by slice with static capacities — an
[Nm]-slot node band and a [Cm]-cell cell array per lane. Each slice:

- projects the band from the previous slice: through the precomputed
  reach table where the graph has one (one gather, one stable sort, a
  first-of-run dedup), else through the iterative relaxation
  (``ops.project_band``, a CUDA kernel on the card) with the batch's
  shared stop rule, as the JAX ``pairwise`` mode does;
- hands the band and the carries to kernel K1 (``ops.banded_cell.
  slice_cells``), which matches the new band against the previous one,
  packs the per-slot predecessor tables (``pred_tab``, ``pred_prev``),
  builds the slice's Eq words and per-cell metadata (the
  ``layout_parallel`` pass), runs the cell pass, repeats it to a bounded
  fixpoint for lanes whose band has a back edge, and returns the per-slice
  outputs, the packed control word and the next carries.

The JAX scan is a ``lax.scan``; here it is a Python loop over slices. As
there, every slice of the compiled capacity ``S_max`` runs for every lane
and inactive lanes are masked, so every output equals the JAX one. All
arrays keep the batch as the last axis ([Nm, B], [Cm, B], [7, Cm, B]).
Nothing in the loop reads back to the host, so the host queues the slices
ahead of the card.
The JAX package's XLA cell pass (``cell_pass_xla``, what it runs past 5
in-neighbours) is K1's wide route here: K1 takes graphs of any in-degree
whose tables fit its shared memory and returns each slot's predecessor tables as ``pred_words(K_in)``
int32 planes (``ops.banded_cell``), so ``pred_tab`` and ``pred_prev`` are
[S, P * Nm, B], plane p at rows p * Nm to (p + 1) * Nm; at P = 1 they are
the JAX package's. On a device mesh (``banded_scan_shards``) the lanes split into contiguous
shards of equal width, each scanned on its own device as the JAX
package's ``shard_map`` runs its shards: with no collective, so the
iterative projection's stop rule is each shard's own there as here.
Not ported: the JAX package's probe projections
(``GA_PROJ`` = sort, sort2, pairwise2, unroll), which give the same bands
as ``pairwise``.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping

import numpy as np
import torch

from ..ops.banded_cell import slice_cells
from ..ops.project_band import project_band
from ..ops.wordops import M32, i32
from ..utils import trace
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
    if Nm > 32:
        raise NotImplementedError(
            "banded scan beyond the cell kernel's packing (Nm <= 32) is not "
            "yet ported"
        )
    N_nodes = dt.num_nodes
    with trace.span("scan.upload"):
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
    with trace.span("scan.issue"):
        iota_nm = torch.arange(Nm, dtype=torch.int32, device=dev)
        iota_cm = torch.arange(Cm, dtype=torch.int32, device=dev)
        slot0 = (iota_nm == 0)[:, None]
        # a fresh seed's slot scores: 0 on slot 0, INF elsewhere
        seed_score = torch.where(slot0, 0, iota_nm[:, None] * 0 + _INF)
        rc_all = read_codes.to(torch.uint8).contiguous()
        # each step's per-lane inputs, for all steps at once ([S, B])
        steps = torch.arange(S_max, dtype=torch.int32, device=dev)[:, None]
        if segmented:
            active_all = seg_active == 1
            first_all = seg_first == 1
            slen_all = seg_slen
            win_all = steps.expand(S_max, B).contiguous()
            resetting_all = seg_rnode >= 0
            rnode_all = torch.where(resetting_all, seg_rnode, 0)
        else:
            active_all = steps < num_steps[None, :]
            win_all = start_slice[None, :] + steps
            first_all = win_all == 0
        tables = (dt.node_len, dt.node_start, dt.in_nbrs, dt.seq_codes,
                  dt.bits_lut)

        ew_all = bandwidth + WORD_SIZE
        first_col = torch.ones((B, 1), dtype=torch.bool, device=dev)

        def project_band_reach(p_ids_bn, p_nmin_bn, p_nend_bn, p_min, bw, ew):
            """Precomputed-reach projection (core/reach.py): band membership is
            m s.t. some qualified seed s has outp0(s) + d*(s, m) <= ew
            (ew = bw + 64)."""
            valid_slot = p_ids_bn < _EMPTY
            qualified = valid_slot & (p_nmin_bn <= (p_min + bw)[:, None])
            outp0 = torch.where(
                qualified & (p_nend_bn <= (p_min + ew)[:, None]),
                p_nend_bn - p_min[:, None] + 1,
                _INF_PRI,
            )
            g = dt.reach[:, p_ids_bn.clamp(0, N_nodes - 1)]  # [2, B, Nm, K]
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
                [first_col, id_s[:, 1:] != id_s[:, :-1]], dim=1,
            ) & (key_s < _I32MAX)
            cnt = first.cumsum(1, dtype=torch.int32)
            over = cnt[:, -1] > Nm
            pos = torch.where(first, cnt - 1, Nm).clamp(max=Nm).long()
            out = torch.full((B, Nm + 1), _EMPTY, dtype=torch.int32,
                             device=dev)
            out.scatter_(1, pos, torch.where(first, id_s, _EMPTY))
            return out[:, :Nm], over

        S = S_max
        nm_steps, ctrl_steps, cols_steps = [], [], []
        p_ids = _i32t(init_ids, dev).T.contiguous()
        p_cell_send = _i32t(init_cell_send, dev).T.contiguous()
        p_node_min = _i32t(init_node_min, dev).T.contiguous()
        p_node_end = _i32t(init_node_end, dev).T.contiguous()
        p_min = init_min
        for t in range(S):
            if segmented:
                # segment start: restart the carry from the seed node
                resetting = resetting_all[t]
                rm = resetting[None, :]
                p_ids = torch.where(
                    rm, torch.where(slot0, rnode_all[t][None, :], _EMPTY),
                    p_ids,
                )
                p_cell_send = torch.where(
                    rm & (iota_cm[:, None] < seg_rlen[t][None, :]), 0,
                    torch.where(rm, _INF, p_cell_send),
                )
                p_node_min = torch.where(rm, seed_score, p_node_min)
                p_node_end = torch.where(rm, seed_score, p_node_end)
                p_min = torch.where(resetting, 0, p_min)
                seq_len_v = slen_all[t]
            else:
                seq_len_v = seq_len

            if dt.reach is not None:
                ids_bn, proj_over = project_band_reach(
                    p_ids.T, p_node_min.T, p_node_end.T, p_min, bandwidth[t],
                    ew_all[t],
                )
            else:
                ids_bn, proj_over = project_band(
                    p_ids.T, p_node_min.T, p_node_end.T, p_min, bandwidth[t],
                    active_all[t], dt.out_nbrs, dt.node_len, dt.topo_rank,
                )
            (cols, nm, ctrl, p_ids, p_cell_send, p_node_min, p_node_end,
             p_min) = slice_cells(
                ids_bn.T.contiguous(), proj_over, p_ids, p_node_min,
                p_node_end, p_cell_send, p_min, active_all[t], first_all[t],
                seq_len_v, rc_all, win_all[t], *tables, P_fix=P_fix,
            )
            nm_steps.append(nm)
            ctrl_steps.append(ctrl)
            cols_steps.append(cols)

        nm_pack = torch.stack(nm_steps)  # [S, 4 + 2P, Nm, B]
        ctrl_pack = torch.stack(ctrl_steps)  # [S, B]
        cols_out = torch.stack(cols_steps)  # [S, 7, Cm, B]
        return _finish_outputs(
            nm_pack, ctrl_pack, cols_out, read_codes, init_min, num_steps,
            (seg_active, seg_rnode) if segmented else None, tie8, Nm,
        )


def _finish_outputs(nm_pack, ctrl_pack, cols, read_codes, init_min,
                    num_steps, seg, tie8, Nm):
    S, B = ctrl_pack.shape
    dev = ctrl_pack.device
    NP = (nm_pack.shape[1] - 4) // 2  # pred planes
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
        "pred_tab": nm_pack[:, 4:4 + NP].reshape(S, NP * Nm, B),
        "pred_prev": nm_pack[:, 4 + NP:].reshape(S, NP * Nm, B),
        "codes": read_codes.to(torch.uint8)
        .reshape(B, -1, WORD_SIZE)
        .permute(1, 2, 0)
        .contiguous(),  # [S, 64, B]
    }


def device_guard(device):
    """``device`` as the current CUDA device (the kernels launch on the
    current device, whatever device their stream belongs to); a no-op
    for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class LaneShards(Mapping):
    """A scan's outputs split along the lane (last) axis into shards of
    ``width`` lanes, shard d holding lanes [d * width, (d + 1) * width) in
    ``parts[d]``, a ``banded_scan`` dict on that shard's device. Lanes are
    addressed by their global index; the aligner gathers no more across
    shards than it takes. As a mapping, ``out[key]`` is the whole batch
    (one shard's tensor itself, else the shards joined on the first
    one's device: for inspection)."""

    def __init__(self, parts: list, width: int):
        self.parts = parts
        self.width = width

    def __getitem__(self, key) -> torch.Tensor:
        ts = [part[key] for part in self.parts]
        if len(ts) == 1:
            return ts[0]
        return torch.cat([t.to(ts[0].device) for t in ts], dim=-1)

    def __iter__(self):
        return iter(self.parts[0])

    def __len__(self) -> int:
        return len(self.parts[0])

    def __contains__(self, key) -> bool:
        return key in self.parts[0]

    def pop(self, key) -> None:
        for part in self.parts:
            part.pop(key, None)

    def keep_sends(self) -> None:
        """``sends`` is a view of ``cols``: copy it so that dropping the
        columns frees their memory."""
        for part in self.parts:
            part["sends"] = part["sends"].clone()

    def nbytes(self, d: int) -> int:
        """Bytes shard d's outputs hold on its device (views once)."""
        seen = {}
        for t in self.parts[d].values():
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return sum(seen.values())

    def host(self, key) -> np.ndarray:
        """Every lane of ``key`` as one host array."""
        with trace.span("fetch"):
            arrs = [part[key].cpu().numpy() for part in self.parts]
        return arrs[0] if len(arrs) == 1 else np.concatenate(arrs, axis=-1)

    def take(self, key, steps, lanes, device) -> torch.Tensor:
        """``key[steps, ..., lanes]`` on ``device``: steps [..., n] and
        lanes [n] (global) integer arrays, the result [..., n, *mid] where
        the output is [S, *mid, B]. Each shard gathers its own lanes."""
        steps = np.asarray(steps, dtype=np.int64)
        lanes = np.asarray(lanes, dtype=np.int64)
        if len(self.parts) == 1:
            t = self.parts[0][key]
            return t[torch.as_tensor(steps, device=t.device), ...,
                     torch.as_tensor(lanes, device=t.device)].to(device)
        t0 = self.parts[0][key]
        out = torch.empty(steps.shape + tuple(t0.shape[1:-1]),
                          dtype=t0.dtype, device=device)
        shard = lanes // self.width
        for d in np.unique(shard):
            sel = np.nonzero(shard == d)[0]
            t = self.parts[d][key]
            part = t[torch.as_tensor(steps[..., sel], device=t.device), ...,
                     torch.as_tensor(lanes[sel] - d * self.width,
                                     device=t.device)]
            out.index_copy_(steps.ndim - 1,
                            torch.as_tensor(sel, device=device),
                            part.to(device))
        return out


def banded_scan_shards(dts, read_codes, bandwidth, init_ids, init_cell_send,
                       init_node_min, init_node_end, init_min, *, S_max,
                       Nm, Cm, seg, tie8=False) -> LaneShards:
    """The segmented ``banded_scan`` over a batch of host (numpy) inputs
    whose B lanes split into ``len(dts)`` contiguous shards of equal width,
    shard d scanned against ``dts[d]`` on its device. Every shard's work
    is issued before anything is read back, so the cards run at once."""
    nd = len(dts)
    B = read_codes.shape[0]
    if B % nd:
        raise ValueError(f"{B} lanes do not split into {nd} equal shards")
    width = B // nd
    zeros = np.zeros(width, dtype=np.int32)
    parts = []
    for d, dt in enumerate(dts):
        lo, hi = d * width, (d + 1) * width
        with device_guard(dt.device):
            parts.append(banded_scan(
                dt, read_codes[lo:hi], zeros, zeros, zeros,
                bandwidth[:, lo:hi], init_ids[lo:hi], init_cell_send[lo:hi],
                init_node_min[lo:hi], init_node_end[lo:hi], init_min[lo:hi],
                S_max=S_max, Nm=Nm, Cm=Cm, tie8=tie8,
                seg=tuple(s[:, lo:hi] for s in seg),
            ))
    return LaneShards(parts, width)
