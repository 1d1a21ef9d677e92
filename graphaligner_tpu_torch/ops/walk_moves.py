"""Backtrace walk emitting packed move codes (kernel K2): wrapper and plain
version.

``walk_moves`` takes the arguments of
``graphaligner_tpu.ops.pallas.walk_moves.walk_moves_kernel`` and returns
(moves [T_w, B], fail [1, B], state_out [16, B], used [1, B]), all int32.
A lane takes at most ``steps`` moves (the TPU kernel's 112 K + 511 unless
the caller gives another) and W_cap a slice. Move codes, K_in <= 4: 0 PAD,
1 STOP, 2 V, 3 H within the node, 4 D within the node, 8+k H via
in-neighbour k, 12+k D via in-neighbour k, nibble t of a lane's stream its
t-th move, T_w = ceil((steps + 1) / 8). Past 4 in-neighbours (the wide
route) the codes are wider (``code_bits``): bytes, four an int32, up to 64
in-neighbours (0 PAD, 1 STOP, 2 V, 3 H, 4 D, 64+k Hk, 128+k Dk), and 16
bits, two an int32, past 64 (0x4000+k Hk, 0x8000+k Dk); T_w = ceil((steps
+ 1) / codes_per_word). The pred tables then hold
``banded_cell.pred_words(K_in)`` planes stacked on the slot axis ([K+1, P
* Nm, B]). The wide route computes what the JAX package runs there, the
XLA walk (``core/backtrace_device.py::walk_batch``), which steps every
lane on its own: its plain version always has per-lane semantics
(``Bb=1``), and the JAX caller's budget comes in as ``steps`` with
``W_cap = steps``.

A CUDA tensor launches ``csrc/walk_moves.cu``: one lane a one-warp block,
four threads weighing its in-neighbours, each slice's walk tables staged
in shared memory (``smem_bytes``: 9.5 KB at Cm=288, 66 KB at Cm=2304),
each lane with its own step budget, so a lane's moves carry no PAD
nibbles. It reads the engine's 7-field columns and the uint8 codes as they
are. The wide route takes the six tables lane-major (``lane_major``, the
layout of ``lane_major_tables``), on the card and on the CPU alike: the
warp stages each slice in 16-byte pieces into one of two slice buffers,
one slice ahead of the walk, and a node start weighs its slot's list of
candidate in-neighbours, read from the pred planes as the slice lands;
its shared bytes do not grow with the in-degree (70,720 at Cm=1152). A
CPU tensor runs ``walk_moves_plain``, which keeps the TPU kernel's
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
from .banded_cell import PRED_PER_WORD, pred_words
from .wordops import M32, col_value, i32

INF = 1 << 20
_EMPTY = 2**31 - 1

LAUNCHES = 0  # the 4-bit route's launches (K_in <= 4)
LAUNCHES_WIDE = 0  # the wide route's launches (K_in past 4)
NIBBLE_K_IN = 4  # the widest in-degree of the 4-bit move code
BYTE_K_IN = 64  # the widest in-degree of the byte move code
WIDEST_K_IN = 0x4000  # the widest in-degree of the 16-bit move code


def codes_per_word(K_in: int) -> int:
    """Move codes an int32 word holds: 8 nibbles up to NIBBLE_K_IN, 4
    bytes up to BYTE_K_IN, else two 16-bit codes."""
    return 8 if K_in <= NIBBLE_K_IN else 4 if K_in <= BYTE_K_IN else 2


def code_bits(K_in: int) -> int:
    """Bits of one move code (4, 8 or 16): the decoder's code width."""
    return 32 // codes_per_word(K_in)


def move_bases(K_in: int) -> tuple[int, int]:
    """The codes of H and D through in-neighbour 0 (in-neighbour k adds
    k), at the code width of in-degree K_in."""
    return {4: (8, 12), 8: (64, 128), 16: (0x4000, 0x8000)}[code_bits(K_in)]


def default_steps(K: int) -> int:
    """The TPU kernel's step budget of a K-slice window."""
    return K * 112 + 511

# The TPU kernel's window limits, copied from
# graphaligner_tpu/ops/pallas/walk_moves.py:45-107 so that long-read mode
# chains the same rounds and fails the same lanes as the JAX package. They
# are Mosaic's scoped-VMEM budget (16 MiB, sized against 15) at a lane
# block of 128, in int32 words a lane, not limits of this kernel, which
# walks any window at any Cm up to 2304.
_VMEM_BUDGET_WORDS = 15 * 2**20 // 4


def _per_lane_words(Cm, Nm, K):
    T_w = (K * 112 + 512 + 7) // 8
    return 24 * Cm + 12 * Nm + T_w + 220


def moves_walk_fits(Cm, Nm) -> bool:
    """Whether the TPU kernel fits any walk window at the 128-lane block
    floor (false from Cm = 1792: long mode then fails the tier's lanes)."""
    return _per_lane_words(Cm, Nm, 32) * 128 <= _VMEM_BUDGET_WORDS


def max_window_slices(Cm, Nm):
    """Largest walk window (slices, a multiple of 16 from 32) whose TPU
    projection fits at the 128-lane floor: the long-mode window cap of a
    capacity tier (1648 at Cm=288, 160 at Cm=1152, Nm=32)."""
    budget = _VMEM_BUDGET_WORDS // 128
    k = 32
    while _per_lane_words(Cm, Nm, k + 16) <= budget:
        k += 16
    return k


def lane_major(K_in: int) -> bool:
    """Whether a call at in-degree K_in takes its six tables lane-major
    (``lane_major_tables``): the wide route, past NIBBLE_K_IN, does; the
    narrow route takes them lane-last."""
    return K_in > NIBBLE_K_IN


def lane_major_tables(tables):
    """The six walk tables of a call (cols [K+1, 7, Cm, B]; band, lens,
    pred, pred_prev [K+1, *, B]; codes [K+1, 64, B]) in the lane-major
    layout the wide route reads: cols [K+1, B, 7, Cm], the others [K+1, B,
    *], so that a lane's slice is a few contiguous runs."""
    cols, *rest = tables
    return (cols.permute(0, 3, 1, 2).contiguous(),
            *(t.permute(0, 2, 1).contiguous() for t in rest))


def lane_last_tables(tables):
    """The inverse of ``lane_major_tables``: the six tables lane-last, the
    layout of the plain walk and the narrow route."""
    cols, *rest = tables
    return (cols.permute(0, 2, 3, 1).contiguous(),
            *(t.permute(0, 2, 1).contiguous() for t in rest))


def table_dims(args, K_in):
    """(K, Cm, Nm, B) of a call's tables at in-degree K_in, in its
    route's layout."""
    cols, band = args[0], args[1]
    if lane_major(K_in):
        K1, B, _, Cm = cols.shape
        return K1 - 1, Cm, band.shape[2], B
    K1, _, Cm, B = cols.shape
    return K1 - 1, Cm, band.shape[1], B


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
    if cols_tab.dim() != 4 or band_tab.dim() != 3:
        raise ValueError("walk_moves: cols_tab must be 4-D, band_tab 3-D")
    major = lane_major(K_in)
    K, Cm, Nm, B = table_dims((cols_tab, band_tab), K_in)
    K1 = K + 1
    PN = pred_words(K_in) * Nm
    if cols_tab.shape[2 if major else 1] != 7:
        raise ValueError("walk_moves: cols_tab must be [K+1, 7, Cm, B], or "
                         f"[K+1, B, 7, Cm] past {NIBBLE_K_IN} in-neighbours")
    if not 1 <= K_in <= WIDEST_K_IN:
        raise ValueError(f"walk_moves: K_in must be 1 to {WIDEST_K_IN} "
                         "(16-bit move codes)")
    if Nm > 32:
        raise NotImplementedError("walk_moves packs pred slots in 5 bits")

    def tab(n):
        return (K1, B, n) if major else (K1, n, B)

    named = {
        "cols_tab": (cols_tab, (K1, B, 7, Cm) if major
                     else (K1, 7, Cm, B), torch.int32),
        "band_tab": (band_tab, tab(Nm), torch.int32),
        "lens_tab": (lens_tab, tab(Nm), torch.int32),
        "pred_tab": (pred_tab, tab(PN), torch.int32),
        "pred_prev_tab": (pred_prev_tab, tab(PN), torch.int32),
        "codes8": (codes8, tab(64), torch.uint8),
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
               K_in: int, W_cap: int = 448, steps: int | None = None):
    """cols_tab [K+1, 7, Cm, B] (entry 0 = the slice below the window),
    band/lens [K+1, Nm, B], pred/pred_prev [K+1, P * Nm, B], codes8 [K+1,
    64, B] uint8, bits_lut [R], seq_len/seed_node/win_base [1, B],
    init_state [16, B]; past NIBBLE_K_IN in-neighbours the six tables in
    the layout of ``lane_major_tables``."""
    args = (cols_tab, band_tab, lens_tab, pred_tab, pred_prev_tab, codes8,
            bits_lut, seq_len, seed_node, win_base, init_state)
    _check(*args, K_in)
    if steps is None:
        steps = default_steps(cols_tab.shape[0] - 1)
    if cols_tab.device.type == "cpu":
        return walk_moves_plain(*args, K_in=K_in, W_cap=W_cap, steps=steps,
                                Bb=256 if K_in <= NIBBLE_K_IN else 1)
    if cols_tab.device.type != "cuda":
        raise ValueError(f"walk_moves: unsupported device {cols_tab.device}")
    return _launch(*[a.contiguous() for a in args], K_in=K_in, W_cap=W_cap,
                   steps=steps)


SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block can opt into
LIST_CAP = 32  # node-start candidates a slot's list holds (csrc LCAP)


def smem_bytes(Cm: int, Nm: int, R: int, K_in: int = 1) -> int:
    """Shared memory of a launch (one lane a block). The narrow route:
    bits_lut, then the lane's tables of one slice, 7 Cm column words, 9
    (Nm + 1) band-table words and 64 code words. The wide route, whatever
    its in-degree: two slice buffers (the next slice lands while the lane
    walks this one) of 7 Cm column words, four band tables and 16 code
    words, then the derived tables (offsets, slot map, list counts, 64
    match masks) and LIST_CAP candidates a slot."""
    if K_in <= NIBBLE_K_IN:
        return 4 * (-(-R // 4) * 4 + 7 * Cm + 9 * (Nm + 1) + 64)
    nb = (Nm + 4) & ~3  # a slot table, in whole 16-byte pieces
    return 4 * (2 * (7 * Cm + 4 * nb + 16) + 4 * nb + 64 + Nm * LIST_CAP)


def _launch(cols_tab, band_tab, lens_tab, pred_tab, pred_prev_tab, codes8,
            bits_lut, seq_len, seed_node, win_base, init_state, *, K_in,
            W_cap, steps):
    global LAUNCHES, LAUNCHES_WIDE
    wide = K_in > NIBBLE_K_IN
    K, Cm, Nm, B = table_dims((cols_tab, band_tab), K_in)
    R = bits_lut.shape[0]
    if R > 256:
        raise ValueError("walk_moves: bits_lut has more than 256 entries")
    smem = smem_bytes(Cm, Nm, R, K_in)
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"walk_moves: a slice's tables at in-degree {K_in}, Cm={Cm}, "
            f"Nm={Nm} take {smem} bytes of shared memory, past the "
            f"{SMEM_LIMIT} a block holds"
        )
    if wide and (Cm % 4 or cols_tab.data_ptr() % 16
                 or codes8.data_ptr() % 16):
        raise ValueError("walk_moves: the wide route copies 16-byte pieces: "
                         "Cm a multiple of 4, tables 16-byte aligned")
    T_total = steps + 1
    per = codes_per_word(K_in)
    T_w = (T_total + per - 1) // per
    dev = cols_tab.device
    moves = torch.zeros((T_w, B), dtype=torch.int32, device=dev)
    fail = torch.empty((1, B), dtype=torch.int32, device=dev)
    state_out = torch.empty((16, B), dtype=torch.int32, device=dev)
    used = torch.empty((1, B), dtype=torch.int32, device=dev)
    lib = _build.library("walk_moves")
    fn = lib.ga_walk_moves_wide if wide else lib.ga_walk_moves
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p
    ]
    err = fn(
        *[a.data_ptr() for a in (cols_tab, band_tab, lens_tab, pred_tab,
                                 pred_prev_tab, codes8, bits_lut, seq_len,
                                 seed_node, win_base, init_state, moves, fail,
                                 state_out, used)],
        K, Cm, Nm, B, K_in, W_cap, T_total, T_w, R, per, smem,
        _build.stream_handle(dev),
    )
    _build.check(err, "walk_moves")
    if wide:
        LAUNCHES_WIDE += 1
    else:
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
                     steps: int | None = None, Bb: int = 256):
    """Plain torch version of K2 (any device) with the TPU kernel's
    lockstep semantics: the lanes of each Bb-wide block step together,
    slice by slice from the top of the window, sharing one step counter
    (the move stream position) and one budget; an idle lane emits PAD.
    At Bb=1 every lane steps on its own, as the CUDA kernel and the JAX
    package's XLA walk do. It takes the tables in the route's layout
    (``lane_major``) and walks lane-major ones after
    ``lane_last_tables``."""
    if lane_major(K_in):
        (cols_tab, band_tab, lens_tab, pred_tab, pred_prev_tab,
         codes8) = lane_last_tables((cols_tab, band_tab, lens_tab, pred_tab,
                                     pred_prev_tab, codes8))
    K1, _, Cm, B = cols_tab.shape
    K = K1 - 1
    Nm = band_tab.shape[1]
    dev = cols_tab.device
    T_total = (default_steps(K) if steps is None else steps) + 1
    per = codes_per_word(K_in)
    bits = 32 // per
    T_w = (T_total + per - 1) // per
    # move codes: H and D within the node, and via in-neighbour k
    c_h, c_d = 3, 4
    c_hk, c_dk = move_bases(K_in)
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
    NP = pred_words(K_in)
    pred = pred_tab.to(torch.int64).reshape(K1, NP, Nm, B)
    pprev = pred_prev_tab.to(torch.int64).reshape(K1, NP, Nm, B)
    dflt = seq_len[0].to(torch.int64)
    seed = seed_node[0].to(torch.int64)
    base = win_base[0].to(torch.int64)
    st = init_state.to(torch.int64).clone()
    moves = torch.zeros(T_w * B, dtype=torch.int64, device=dev)
    word = torch.zeros(B, dtype=torch.int64, device=dev)
    ctr = torch.zeros(nb, dtype=torch.int64, device=dev)

    ks = torch.arange(K_in, device=dev)[:, None]
    k_plane = ks // PRED_PER_WORD
    k_shift = 6 * (ks % PRED_PER_WORD)

    def rd_nm(tab, idx):
        """One-hot read over the Nm slots (out-of-range slots read 0);
        idx is [B] or [K_in, B]."""
        ok = (idx >= 0) & (idx < Nm)
        v = tab.gather(0, idx.clamp(0, Nm - 1).reshape(-1, B))
        return torch.where(ok, v.reshape(idx.shape), 0)

    def rd_pred(planes, slot):
        """[K_in, B]: each in-neighbour's pred word of slot [B], shifted
        to its field (an out-of-range slot reads 0)."""
        ok = (slot >= 0) & (slot < Nm)
        idx = k_plane * Nm + slot.clamp(0, Nm - 1)
        v = planes.flatten(0, 1).gather(0, idx)
        return torch.where(ok, v, 0) >> k_shift

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
            pw = rd_pred(pred_c, slot)
            ppw = rd_pred(pprev_c, slot)
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
            # the reference's priority: per in-neighbour H then D, in
            # order, so the first in-neighbour with either wins, H first
            cand = (h_ok | d_ok) & ~decided
            take = cand.any(0)
            kw = cand.to(torch.int8).argmax(0)

            def pick(t):
                return t.gather(0, kw[None])[0]

            take_h = take & pick(h_ok)
            take_d = take & ~take_h
            move = torch.where(take_h, torch.where(is_start, c_hk + kw, c_h),
                               move)
            move = torch.where(take_d, torch.where(is_start, c_dk + kw, c_d),
                               move)
            n_slot = torch.where(take, pick(u_slot), n_slot)
            n_off = torch.where(take, pick(u_off), n_off)
            n_row = torch.where(take_d, row_in - 1, n_row)
            n_here = torch.where(take_h | (take_d & ~matched), here - 1,
                                 n_here)
            n_col = torch.where(
                take[None], u_col.gather(1, kw[None, None].expand(5, 1, B))[:, 0],
                n_col)
            # a D into an in-neighbour only in the previous band lands there
            po_any = take_d & pick(prev_only)
            po_slot, po_off = pick(pslots_prev), pick(po_offs)
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
            w = word | (move << (bits * (t % per)))
            last = (t % per) == per - 1
            flush = run_l & last
            tgt = (t // per).clamp(max=T_w - 1) * B + lanes
            moves.scatter_(0, tgt, torch.where(flush, w, moves.gather(0, tgt)))
            word = torch.where(run_l, torch.where(last, 0, w), word)
            ctr = ctr + running.to(torch.int64)
            running = running & blk_any(
                (st[0] == q) & (st[5] == 0) & (st[6] == 0)
            )
            it += 1
    t = ctr[blk]
    tgt = (t // per).clamp(max=T_w - 1) * B + lanes
    moves.scatter_(0, tgt, word)
    fail = (st[6] == 1) | ((st[5] == 0) & (st[0] > base))
    return (
        i32(moves.reshape(T_w, B)),
        fail.to(torch.int32)[None],
        i32(st),
        t.to(torch.int32)[None],
    )
