"""Backtrace walk emitting 4-bit move codes (kernel K2): wrapper and plain
version.

``walk_moves`` takes the arguments of
``graphaligner_tpu.ops.pallas.walk_moves.walk_moves_kernel`` and returns
(moves [T_w, B], fail [1, B], state_out [16, B], used [1, B]), all int32,
with T_w = ceil((112 K + 512) / 8). Move codes (K_in <= 4): 0 PAD, 1 STOP,
2 V, 3 H within the node, 4 D within the node, 8+k H via in-neighbour k,
12+k D via in-neighbour k; nibble t of a lane's stream is its t-th move.

A CUDA tensor launches ``csrc/walk_moves.cu``: one lane a one-warp block,
four threads weighing its in-neighbours, each slice's walk tables staged
in shared memory (``smem_bytes``: 9.5 KB at Cm=288, 66 KB at Cm=2304),
each lane with its own step budget, so a lane's moves carry no PAD
nibbles. It reads the engine's 7-field columns and the uint8 codes as they
are. A CPU tensor runs ``walk_moves_plain``, which keeps the TPU kernel's
lockstep semantics block by block (``Bb`` lanes share one step counter and
budget), so at the same block width its raw moves, fail flags and ``used``
equal the JAX kernel's; at ``Bb=1`` it has the kernel's per-lane semantics
and equals it bit for bit. The native decoder skips PAD per lane: every block width
gives the same traces.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .wordops import M32, col_value, i32

INF = 1 << 20
_EMPTY = 2**31 - 1

LAUNCHES = 0


def _prologue(cols_tab, codes8, bits_lut):
    """The plain version's inputs: the match-mask table [K+1, 64, B] and
    the 6-field columns [K+1, 6, Cm, B] (field 4 = sbs | e << 24, field 5 =
    send)."""
    R = bits_lut.shape[0]
    c = codes8.to(torch.int64)
    mtab = torch.where(c < R, bits_lut[c.clamp(max=R - 1)], 0).to(torch.int32)
    cols6 = torch.cat(
        [
            cols_tab[:, :4],
            (cols_tab[:, 4:5] & 0xFFFFFF) | (cols_tab[:, 6:7] << 24),
            cols_tab[:, 5:6],
        ],
        dim=1,
    ).contiguous()
    return mtab.contiguous(), cols6


def _check(cols_tab, band_tab, lens_tab, pred_tab, pred_prev_tab, codes8,
           bits_lut, seq_len, seed_node, win_base, init_state, K_in):
    K1, F, Cm, B = cols_tab.shape
    Nm = band_tab.shape[1]
    if F != 7:
        raise ValueError("walk_moves: cols_tab must be [K+1, 7, Cm, B]")
    if K_in > 4:
        raise NotImplementedError(
            "the 4-bit move code encodes k_in <= 4; the XLA walk for wider "
            "in-degree (backtrace_device.walk_batch) is not yet ported"
        )
    if Nm > 32:
        raise NotImplementedError("walk_moves packs pred slots in 5 bits")
    named = {
        "cols_tab": (cols_tab, (K1, 7, Cm, B), torch.int32),
        "band_tab": (band_tab, (K1, Nm, B), torch.int32),
        "lens_tab": (lens_tab, (K1, Nm, B), torch.int32),
        "pred_tab": (pred_tab, (K1, Nm, B), torch.int32),
        "pred_prev_tab": (pred_prev_tab, (K1, Nm, B), torch.int32),
        "codes8": (codes8, (K1, 64, B), torch.uint8),
        "seq_len": (seq_len, (1, B), torch.int32),
        "seed_node": (seed_node, (1, B), torch.int32),
        "win_base": (win_base, (1, B), torch.int32),
        "init_state": (init_state, (16, B), torch.int32),
    }
    for name, (a, shape, dtype) in named.items():
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"walk_moves: {name} must be {dtype} {shape}, "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device != cols_tab.device:
            raise ValueError("walk_moves: inputs on different devices")
    if bits_lut.dtype != torch.int32 or bits_lut.device != cols_tab.device:
        raise ValueError("walk_moves: bits_lut must be int32 on the device")
    if K1 < 2:
        raise ValueError("walk_moves: need at least one walked slice")


def walk_moves(cols_tab, band_tab, lens_tab, pred_tab, pred_prev_tab, codes8,
               bits_lut, seq_len, seed_node, win_base, init_state, *,
               K_in: int, W_cap: int = 448):
    """cols_tab [K+1, 7, Cm, B] (entry 0 = the slice below the window),
    band/lens/pred/pred_prev [K+1, Nm, B], codes8 [K+1, 64, B] uint8,
    bits_lut [R], seq_len/seed_node/win_base [1, B], init_state [16, B]."""
    args = (cols_tab, band_tab, lens_tab, pred_tab, pred_prev_tab, codes8,
            bits_lut, seq_len, seed_node, win_base, init_state)
    _check(*args, K_in)
    if cols_tab.device.type == "cpu":
        return walk_moves_plain(*args, K_in=K_in, W_cap=W_cap)
    if cols_tab.device.type != "cuda":
        raise ValueError(f"walk_moves: unsupported device {cols_tab.device}")
    return _launch(*[a.contiguous() for a in args], K_in=K_in, W_cap=W_cap)


SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block can opt into


def smem_bytes(Cm: int, Nm: int, R: int) -> int:
    """Shared memory of a launch (one lane a block): bits_lut, then the
    lane's tables of one slice, 7 Cm column words, 9 (Nm + 1) band-table
    words and 64 code words."""
    return 4 * (-(-R // 4) * 4 + 7 * Cm + 9 * (Nm + 1) + 64)


def _launch(cols_tab, band_tab, lens_tab, pred_tab, pred_prev_tab, codes8,
            bits_lut, seq_len, seed_node, win_base, init_state, *, K_in,
            W_cap):
    global LAUNCHES
    K1, _, Cm, B = cols_tab.shape
    K = K1 - 1
    Nm = band_tab.shape[1]
    R = bits_lut.shape[0]
    if R > 256:
        raise ValueError("walk_moves: bits_lut has more than 256 entries")
    smem = smem_bytes(Cm, Nm, R)
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"walk_moves: a slice of Cm={Cm}, Nm={Nm} does not fit in shared "
            "memory"
        )
    T_total = K * 112 + 512
    T_w = (T_total + 7) // 8
    dev = cols_tab.device
    moves = torch.zeros((T_w, B), dtype=torch.int32, device=dev)
    fail = torch.empty((1, B), dtype=torch.int32, device=dev)
    state_out = torch.empty((16, B), dtype=torch.int32, device=dev)
    used = torch.empty((1, B), dtype=torch.int32, device=dev)
    fn = _build.library("walk_moves").ga_walk_moves
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    err = fn(
        *[a.data_ptr() for a in (cols_tab, band_tab, lens_tab, pred_tab,
                                 pred_prev_tab, codes8, bits_lut, seq_len,
                                 seed_node, win_base, init_state, moves, fail,
                                 state_out, used)],
        K, Cm, Nm, B, K_in, W_cap, T_total, T_w, R, smem,
        _build.stream_handle(dev),
    )
    _build.check(err, "walk_moves")
    LAUNCHES += 1
    return moves, fail, state_out, used


def block_width(B: int, Bb: int = 256) -> int:
    """Lockstep block width: the largest halving of Bb that divides B."""
    Bb = min(Bb, B)
    while B % Bb:
        Bb //= 2
    return Bb


def walk_moves_plain(cols_tab, band_tab, lens_tab, pred_tab, pred_prev_tab,
                     codes8, bits_lut, seq_len, seed_node, win_base,
                     init_state, *, K_in: int, W_cap: int = 448,
                     Bb: int = 256):
    """Plain torch version of K2 (any device) with the TPU kernel's
    lockstep semantics: the lanes of each Bb-wide block step together,
    slice by slice from the top of the window, sharing one step counter
    (the move stream position) and one budget; an idle lane emits PAD."""
    K1, _, Cm, B = cols_tab.shape
    K = K1 - 1
    Nm = band_tab.shape[1]
    dev = cols_tab.device
    T_total = K * 112 + 512
    T_w = (T_total + 7) // 8
    Bb = block_width(B, Bb)
    nb = B // Bb
    blk = torch.arange(B, device=dev) // Bb
    lanes = torch.arange(B, device=dev)
    iota_nm = torch.arange(Nm, device=dev)[:, None]
    mtab, cols6 = _prologue(cols_tab, codes8, bits_lut)
    mtab = mtab.to(torch.int64)
    cols6 = cols6.to(torch.int64)
    band = band_tab.to(torch.int64)
    lens = lens_tab.to(torch.int64)
    pred = pred_tab.to(torch.int64)
    pprev = pred_prev_tab.to(torch.int64)
    dflt = seq_len[0].to(torch.int64)
    seed = seed_node[0].to(torch.int64)
    base = win_base[0].to(torch.int64)
    st = init_state.to(torch.int64).clone()
    moves = torch.zeros(T_w * B, dtype=torch.int64, device=dev)
    word = torch.zeros(B, dtype=torch.int64, device=dev)
    ctr = torch.zeros(nb, dtype=torch.int64, device=dev)

    ks = torch.arange(K_in, device=dev)[:, None]

    def rd_nm(tab, idx):
        """One-hot read over the Nm slots (out-of-range slots read 0);
        idx is [B] or [K_in, B]."""
        ok = (idx >= 0) & (idx < Nm)
        v = tab.gather(0, idx.clamp(0, Nm - 1).reshape(-1, B))
        return torch.where(ok, v.reshape(idx.shape), 0)

    def blk_any(mask):
        return torch.zeros(nb, dtype=torch.int64, device=dev).index_add_(
            0, blk, mask.to(torch.int64)
        ) > 0

    def unpacked_value(cp, r):
        return col_value(cp[0] & M32, cp[1] & M32, cp[2] & M32, cp[3] & M32,
                         cp[4] & 0xFFFFFF, r)

    for s in range(K):
        cur = K - s
        prv = cur - 1
        q = base + cur
        lens_c, lens_p = lens[cur], lens[prv]
        offs_c = lens_c.cumsum(0) - lens_c
        offs_p = lens_p.cumsum(0) - lens_p
        band_c, band_p = band[cur], band[prv]
        band_p_ok = band_p < _EMPTY
        pred_c, pprev_c = pred[cur], pprev[cur]
        mt = mtab[cur]
        cols_cur = cols6[cur, :5]  # [5, Cm, B]
        send_prev = cols6[prv, 5]  # [Cm, B]

        def read_col(cell):
            """Packed columns at cell [B] or [K_in, B] -> [5, *cell.shape]."""
            idx = cell.clamp(0, Cm - 1).reshape(1, -1, B).expand(5, -1, B)
            return cols_cur.gather(1, idx).reshape((5,) + tuple(cell.shape))

        def prev_slot_of(node_id):
            eqp = (band_p == node_id[None]) & band_p_ok
            return eqp.any(0), (eqp * iota_nm).sum(0)

        def prev_value(node_id, off):
            found, pslot = prev_slot_of(node_id)
            cell = (rd_nm(offs_p, pslot) + off).clamp(0, Cm - 1)
            v = torch.where(found, send_prev.gather(0, cell[None])[0], dflt)
            init_v = torch.where(node_id == seed, 0, dflt)
            return torch.where(q == 1, init_v, v)

        running = blk_any((st[0] == q) & (st[5] == 0) & (st[6] == 0))
        it = 0
        while True:
            running = running & (it < W_cap) & (ctr < T_total - 1)
            if not bool(running.any()):
                break
            run_l = running[blk]
            sk, row_in, slot, off, here = st[0], st[1], st[2], st[3], st[4]
            needs_col = st[7] == 1
            active = (sk == q) & (st[5] == 0) & (st[6] == 0) & run_l
            cell = rd_nm(offs_c, slot) + off
            colp = torch.where(
                (active & needs_col)[None], read_col(cell), st[8:13]
            )
            node_id = rd_nm(band_c, slot)
            is_start = off == 0
            grow = (q - 1) * 64 + row_in
            code = ((colp[4] & M32) >> 25) & 7
            r_ok = (row_in >= 0) & (row_in < 64)
            mrow = torch.where(
                r_ok, mt.gather(0, row_in.clamp(0, 63)[None])[0], 0
            )
            matched = ((mrow >> code) & 1) == 1
            spec = (active & (grow == 0) & (node_id == seed) & (here >= 0)
                    & (here <= 1))
            decided = spec | ~active
            move = spec.to(torch.int64)
            n_slot, n_off, n_here = slot, off, here
            n_row = torch.where(spec, row_in - 1, row_in)
            n_col = colp
            # per in-neighbour k ([K_in, B]): its slots in this band and in
            # the previous one, and the column a move through it lands on
            pw = rd_nm(pred_c, slot)[None] >> (6 * ks)
            ppw = rd_nm(pprev_c, slot)[None] >> (6 * ks)
            pslots, pvalid = pw & 31, ((pw >> 5) & 1) == 1
            pslots_prev, pprev_valid = ppw & 31, ((ppw >> 5) & 1) == 1
            u_slot = torch.where(is_start, pslots, slot)
            u_off = torch.where(is_start, rd_nm(lens_c, pslots) - 1, off - 1)
            uv = active & torch.where(ks == 0, pvalid | ~is_start,
                                      is_start & pvalid)
            prev_only = (active & is_start & (row_in == 0) & ~pvalid
                         & pprev_valid)
            u_col = read_col(rd_nm(offs_c, u_slot) + u_off)  # [5, K_in, B]
            # boundary (row 0) values from the previous slice: per pred,
            # then (row K_in) the node's own previous-slice value
            bd = dflt.expand(K_in + 1, B)
            po_offs = dflt.expand(K_in, B)
            if bool((active & (row_in == 0)).any()):
                wn_d = prev_value(node_id, off - 1)
                po_offs = rd_nm(lens_p, pslots_prev) - 1
                cellp = (rd_nm(offs_p, pslots_prev) + po_offs).clamp(0, Cm - 1)
                v = torch.where(q == 1, 0, send_prev.gather(0, cellp))
                sv = torch.where(pprev_valid, v, dflt)
                bd = torch.cat([torch.where(is_start, sv, wn_d),
                                prev_value(node_id, off)[None]])
            # one masked popcount for every candidate: H and D per pred, V
            rows = torch.cat([row_in.expand(K_in, B),
                              (row_in - 1).expand(K_in + 1, B)])
            vals = unpacked_value(
                torch.cat([u_col, u_col, colp[:, None]], 1), rows
            )
            h_ok = uv & (vals[:K_in] == here - 1)
            diag = torch.where(row_in == 0, bd[:K_in], vals[K_in:2 * K_in])
            d_ok = (uv | prev_only) & torch.where(matched, diag == here,
                                                  diag == here - 1)
            vert = torch.where(row_in == 0, bd[K_in], vals[2 * K_in])
            po_any = torch.zeros(B, dtype=torch.bool, device=dev)
            po_slot = torch.zeros(B, dtype=torch.int64, device=dev)
            po_off = torch.zeros(B, dtype=torch.int64, device=dev)
            # the reference's priority: per in-neighbour H then D, in order
            for k in range(K_in):
                take_h = h_ok[k] & ~decided
                take_d = d_ok[k] & ~decided & ~take_h
                take = take_h | take_d
                move = torch.where(take_h, torch.where(is_start, 8 + k, 3),
                                   move)
                move = torch.where(take_d, torch.where(is_start, 12 + k, 4),
                                   move)
                n_slot = torch.where(take, u_slot[k], n_slot)
                n_off = torch.where(take, u_off[k], n_off)
                n_row = torch.where(take_d, row_in - 1, n_row)
                n_here = torch.where(take_h | (take_d & ~matched), here - 1,
                                     n_here)
                n_col = torch.where(take[None], u_col[:, k], n_col)
                po_fire = take_d & prev_only[k]
                po_any = po_any | po_fire
                po_slot = torch.where(po_fire, pslots_prev[k], po_slot)
                po_off = torch.where(po_fire, po_offs[k], po_off)
                decided = decided | take
            take_v = active & (vert == here - 1) & ~decided
            move = torch.where(take_v, 2, move)
            n_row = torch.where(take_v, row_in - 1, n_row)
            n_here = torch.where(take_v, here - 1, n_here)
            decided = decided | take_v

            new_fail = active & ~decided
            moved_down = decided & ~spec & (n_row < row_in) & (row_in == 0)
            t_slot = prev_slot_of(rd_nm(band_c, n_slot))[1]
            t_slot = torch.where(po_any, po_slot, t_slot)
            n_off = torch.where(po_any, po_off, n_off)
            new = torch.stack([
                torch.where(moved_down, sk - 1, sk),
                torch.where(moved_down, 63, n_row),
                torch.where(moved_down, t_slot, n_slot),
                n_off,
                n_here,
                (spec | ((q == 1) & moved_down)).to(torch.int64),
                new_fail.to(torch.int64),
                moved_down.to(torch.int64),
            ])
            st[:8] = torch.where(active[None], new, st[:8])
            st[8:13] = torch.where(active[None], n_col, st[8:13])

            # lockstep emission: every lane of a running block writes its
            # nibble (PAD when idle) at the block's step counter
            move = torch.where(active, move, 0)
            t = ctr[blk]
            w = word | (move << (4 * (t % 8)))
            last = (t % 8) == 7
            flush = run_l & last
            tgt = (t // 8).clamp(max=T_w - 1) * B + lanes
            moves.scatter_(0, tgt, torch.where(flush, w, moves.gather(0, tgt)))
            word = torch.where(run_l, torch.where(last, 0, w), word)
            ctr = ctr + running.to(torch.int64)
            running = running & blk_any(
                (st[0] == q) & (st[5] == 0) & (st[6] == 0)
            )
            it += 1
    t = ctr[blk]
    tgt = (t // 8).clamp(max=T_w - 1) * B + lanes
    moves.scatter_(0, tgt, word)
    fail = (st[6] == 1) | ((st[5] == 0) & (st[0] > base))
    return (
        i32(moves.reshape(T_w, B)),
        fail.to(torch.int32)[None],
        i32(st),
        t.to(torch.int32)[None],
    )
