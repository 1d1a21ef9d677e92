// Backtrace walk emitting packed move codes (kernel K2) for Hopper, sm_90a.
//
// Replaces graphaligner_tpu/ops/pallas/walk_moves.py::walk_moves_kernel:
// from each lane's start (slice, slot, offset, score) the walk descends
// the DP table with the reference's predecessor priority (row-0 STOP on
// the seed node, then per in-neighbour H then D, then V), including the
// row-0 diagonal into predecessors present only in the previous band
// (pred_prev), and emits one move nibble per step, 8 per int32 word. The
// window semantics are kept (win_base, init_state in, state_out out), so a
// windowed long-read walk can chain calls; the whole-table walk is one
// window with base 0.
//
// Budgets are per lane (W_cap steps a slice, T_total steps in all), so a
// lane emits no PAD while others step: its moves, fail flag, state_out and
// used equal walk_moves_plain(..., Bb=1), which has per-lane semantics.
// The TPU kernel steps a block of lanes in lockstep with one shared budget;
// the native decoder skips PAD per lane, so both decode to the same traces.
//
// Layout: one lane a block of one warp. Before the lane walks slice `cur`,
// the warp stages into shared memory, with cp.async, everything a step of
// that slice can read: fields 0-4 and e (field 6) of cur's Cm cells (a
// cell's six words adjacent), send (field 5) of the previous slice,
// band/lens/pred/pred_prev of cur, band/lens of the previous slice, and the
// 64 read codes of cur; then derives the exclusive prefix offsets of both
// bands (a warp scan), the match mask of each row (through bits_lut) and a
// map from each cur slot to its slot in the previous band (summed over
// equal ids below GA_EMPTY, -1 when absent; entry Nm maps node 0, what an
// out-of-range slot reads). Slices the lane does not step in are skipped.
// At Cm=288 a slice is 9.5 KB, at Cm=2304 66 KB.
//
// A step: inside a node above row 0, the only candidates are H and D to
// the previous offset and V; every thread weighs them from shared memory.
// At a node start, at row 0 or at the table's first row, the full priority
// runs: thread k (k < K_in) weighs in-neighbour k (its slot, offset and
// column, its H and D tests, the row-0 boundary values), two ballots give
// the lane's four (H, D) pairs, the winner is STOP, else the lowest k with
// H or D (H first), else V, exactly the serial loop of the reference
// kernel, and its offset and column come from its thread by shuffles.
// Every index is clamped (cells to [0, Cm - 1], slots to the zero entry
// Nm), so threads 4-31, which hold the lane on an idle state, step on
// harmless values and store nothing.
//
// What bounds it: the walk reads only the columns along each lane's path,
// a small part of the [K+1, 7, Cm, B] table; counted from the walk that
// ran (chip_smoke.py), its floor is the integer work, 0.021 ms at the
// int32 issue rate for 256 longsim lanes at K=160. What sets its time is
// each lane's chain of about 10,000 dependent steps. The kernel it
// replaces read each step's pred word, in-neighbour length and offset and
// column from device memory (four L2 latencies a step, with 32-load slot
// scans and 64-load prefix sums a slice): 21.289 ms at K=160, Cm=288,
// B=256. Here a step's reads are shared-memory loads, and the warp takes
// the in-neighbours' path only when its lane needs it (at its own node
// starts and row-0 steps; with 8 lanes a warp, this kernel's first design,
// the warp took it whenever any of its lanes did): 4.297 ms for the same
// 256 lanes, 4.416 ms for the widest main-path call's 384, about 420 ns a
// step of the longest lane (first design: 7.915 and 9.006 ms), 9.902 ms for
// 128 lanes at Cm=2304; NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py.
//
// The wide route (walk_moves_kernel<true>, past 4 in-neighbours) computes
// what the JAX package runs there, its XLA walk (graphaligner_tpu/core/
// backtrace_device.py::walk_batch), with the same priority. The
// in-neighbours go in chunks of 32: in chunk j thread t weighs
// in-neighbour 32 j + t, two ballots over the whole warp give the chunk's
// H and D, and the first chunk with any legal move decides, its winner the
// lowest set bit of H | D (lowest k, H before D); its slot, offset and
// column come from its thread by shuffles. In-neighbour 0, which also
// stands for the within-node move off a node start, is thread 0 of chunk
// 0; past chunk 0 only node starts have candidates, so a step elsewhere
// weighs one chunk. Its moves are byte codes, four an int32 word (0 PAD,
// 1 STOP, 2 V, 3 H, 4 D, 64+k Hk, 128+k Dk), up to 64 in-neighbours, and
// 16-bit codes, two a word (0x4000+k Hk, 0x8000+k Dk), past 64 (A.PER
// codes a word). Its pred tables are NP = ceil(K_in / 5) planes a slot
// ([K+1, NP * Nm, B], plane p holding in-neighbours 5p to 5p + 4), staged
// as NP (Nm + 1) shared words each, which bounds K_in by shared memory
// alone. The caller gives it walk_batch's budget (T_total - 1 steps, W_cap
// no tighter). The fast path inside a node and the staging are the narrow
// route's.
#include <cuda_runtime.h>

#include <cstdint>

#include "wordops.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Args {
  const int32_t *cols;  // [K+1, 7, Cm, B]
  const int32_t *band, *lens, *pred, *pprev;  // [K+1, Nm, B]
  const uint8_t *codes;  // [K+1, 64, B]
  const int32_t *lut;  // [R] read code -> match mask
  const int32_t *seq_len, *seed, *win_base;  // [1, B]
  const int32_t *init_state;  // [16, B]
  int32_t *moves;  // [T_w, B], zero on entry
  int32_t *fail, *state_out, *used;  // [1, B], [16, B], [1, B]
  int K, Cm, Nm, B, K_in, W_cap, T_total, T_w, R;
  int NP;  // pred planes: 1 on the narrow route
  int PER;  // move codes an int32 word: 8, 4 or 2
};

// The block's lane's tables of one slice.
struct Buf {
  int32_t *cols;  // [Cm][6]: fields 0-4 of cur's cells, then e (field 6)
  int32_t *send;  // [Cm]: field 5 of the previous slice
  int32_t *band_c, *lens_c, *band_p, *lens_p;  // [Nm+1]
  int32_t *pred_c, *pprev_c;  // [NP][Nm+1]
  int32_t *offs_c, *offs_p, *map;  // [Nm+1]
  int32_t *mrow;  // [64]: staged code words, then match masks
};

__device__ __forceinline__ Buf buf_at(int32_t *base, const Args &A) {
  const int n = A.Nm + 1;
  Buf S;
  S.cols = base;
  S.send = S.cols + 6 * A.Cm;
  S.band_c = S.send + A.Cm;
  S.lens_c = S.band_c + n;
  S.pred_c = S.lens_c + n;
  S.pprev_c = S.pred_c + A.NP * n;
  S.band_p = S.pprev_c + A.NP * n;
  S.lens_p = S.band_p + n;
  S.offs_c = S.lens_p + n;
  S.offs_p = S.offs_c + n;
  S.map = S.offs_p + n;
  S.mrow = S.map + n;
  return S;
}

__device__ __forceinline__ uintptr_t code_addr(const Args &A, int c, int r,
                                               int b) {
  return (uintptr_t)(A.codes + ((size_t)c * 64 + r) * A.B + b);
}

// Issue the copies of slice c (c >= 1) for lane b, a word a thread at a
// time over the warp.
__device__ void stage(const Args &A, const Buf &S, int c, int b, int tid) {
  const int Cm = A.Cm, Nm = A.Nm;
  const size_t sB = (size_t)A.B;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const int g = f < 5 ? f : 6;
    const int32_t *src = A.cols + (((size_t)c * 7 + g) * Cm + tid) * sB + b;
    for (int x = tid; x < Cm; x += 32, src += 32 * sB)
      cp_async4(S.cols + x * 6 + f, src);
  }
  {
    const int32_t *src =
        A.cols + (((size_t)(c - 1) * 7 + 5) * Cm + tid) * sB + b;
    for (int x = tid; x < Cm; x += 32, src += 32 * sB)
      cp_async4(S.send + x, src);
  }
  const int32_t *tab_src[4] = {A.band, A.lens, A.band, A.lens};
  int32_t *tab_dst[4] = {S.band_c, S.lens_c, S.band_p, S.lens_p};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int sl = a < 2 ? c : c - 1;
    if (tid < Nm)
      cp_async4(tab_dst[a] + tid,
                tab_src[a] + ((size_t)sl * Nm + tid) * sB + b);
  }
  // pred and pred_prev, plane by plane ([K+1, NP * Nm, B])
  for (int p = 0; p < A.NP; ++p)
    if (tid < Nm) {
      const size_t row = (size_t)c * A.NP * Nm + p * Nm + tid;
      cp_async4(S.pred_c + p * (Nm + 1) + tid, A.pred + row * sB + b);
      cp_async4(S.pprev_c + p * (Nm + 1) + tid, A.pprev + row * sB + b);
    }
  // codes: the aligned word that holds the lane's byte, one a row
  for (int r = tid; r < 64; r += 32)
    cp_async4(S.mrow + r,
              (const void *)(code_addr(A, c, r, b) & ~(uintptr_t)3));
}

// After slice c's copies landed: the prefix offsets of both bands (a warp
// scan, a slot a thread), the slot map and the match masks.
__device__ void derive(const Args &A, const Buf &S, int c, int b, int tid,
                       const int32_t *lut) {
  const int Nm = A.Nm;
  for (int side = 0; side < 2; ++side) {
    const int32_t *lens = side ? S.lens_p : S.lens_c;
    int32_t *offs = side ? S.offs_p : S.offs_c;
    const int32_t len = tid < Nm ? lens[tid] : 0;
    int32_t incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t x = __shfl_up_sync(FULL, incl, d);
      if (tid >= d) incl += x;
    }
    if (tid < Nm) offs[tid] = incl - len;
    if (tid == 0) offs[Nm] = 0;
  }
  // the map: slot j's node among the previous band's ids below GA_EMPTY
  for (int j = tid; j <= Nm; j += 32) {
    const int32_t node = j < Nm ? S.band_c[j] : 0;
    int32_t ps = 0;
    bool found = false;
    for (int i = 0; i < Nm; ++i) {
      const int32_t id = S.band_p[i];
      const bool m = id == node && id < GA_EMPTY;
      ps += m ? i : 0;
      found |= m;
    }
    S.map[j] = found ? ps : -1;
  }
  // byte r of the lane sits at (code_addr(c, 0) + r * B) & 3
  const int sh0 = (int)(code_addr(A, c, 0, b) & 3), bq = A.B & 3;
  for (int r = tid; r < 64; r += 32) {
    const uint32_t w = (uint32_t)S.mrow[r];
    const int code = (w >> (((sh0 + r * bq) & 3) * 8)) & 0xFF;
    S.mrow[r] = code < A.R ? lut[code] : 0;
  }
}

__device__ __forceinline__ int clamp_cell(int32_t cell, int Cm) {
  return cell < 0 ? 0 : (cell > Cm - 1 ? Cm - 1 : cell);
}

// the walk's packed column: 4 word halves + (sbs | e << 24)
__device__ __forceinline__ void read_col(const Buf &S, int cell,
                                         int32_t (&w)[5]) {
  const int32_t *p = S.cols + cell * 6;
#pragma unroll
  for (int f = 0; f < 4; ++f) w[f] = p[f];
  w[4] = (int32_t)(((uint32_t)p[4] & 0xFFFFFFu) | ((uint32_t)p[5] << 24));
}

// The score of a packed column at row r (col_value of wordops.cuh, r
// clamped to [0, 63]) as sbs + popc(vp & mask) - popc(vn & mask), with the
// mask of r computed once for every column read at that row.
struct RowMask {
  uint32_t lo, hi;
};

__device__ __forceinline__ RowMask row_mask(int32_t r) {
  r = r < 0 ? 0 : (r > 63 ? 63 : r);
  const uint64_t m = r >= 63 ? ~0ull : ((1ull << (r + 1)) - 1ull);
  return {(uint32_t)m, (uint32_t)(m >> 32)};
}

__device__ __forceinline__ int32_t masked_value(const int32_t (&w)[5],
                                                RowMask m) {
  return (w[4] & 0xFFFFFF) + __popc((uint32_t)w[0] & m.lo) +
         __popc((uint32_t)w[1] & m.hi) - __popc((uint32_t)w[2] & m.lo) -
         __popc((uint32_t)w[3] & m.hi);
}

}  // namespace

// One lane a block (one warp): threads 0-3 walk it (narrow) or all 32
// (wide, thread k weighing in-neighbour k), and the whole warp stages and
// derives its slices. On the narrow route threads 4-31 step with the lane's
// tables on an idle state (done), so every warp collective has all 32
// threads.
template <bool WIDE>
__global__ void __launch_bounds__(32) walk_moves_kernel(Args A) {
  extern __shared__ __align__(16) int32_t smem[];
  const int tid = threadIdx.x;
  const int Cm = A.Cm, Nm = A.Nm;
  const int b = blockIdx.x;
  const bool valid = WIDE || tid < 4;
  // the code width, and the codes of H and D through in-neighbour k
  const int PER = WIDE ? A.PER : 8, BITS = 32 / PER;
  const int C_HK = !WIDE ? 8 : PER == 4 ? 64 : 0x4000;
  const int C_DK = !WIDE ? 12 : PER == 4 ? 128 : 0x8000;
  const size_t sB = (size_t)A.B;
  auto sidx = [&](int32_t slot) { return (slot >= 0 && slot < Nm) ? slot : Nm; };

  int32_t *lut = smem;
  for (int r = tid; r < A.R; r += 32) lut[r] = A.lut[r];
  const Buf S = buf_at(smem + ((A.R + 3) & ~3), A);
  if (tid == 0) {  // the out-of-range slot reads 0
    S.band_c[Nm] = 0;
    S.lens_c[Nm] = 0;
    S.lens_p[Nm] = 0;
    for (int p = 0; p < A.NP; ++p) {
      S.pred_c[p * (Nm + 1) + Nm] = 0;
      S.pprev_c[p * (Nm + 1) + Nm] = 0;
    }
  }

  // lane state: 0 sk, 1 row_in, 2 slot, 3 off, 4 here, 5 done, 6 fail,
  // 7 needs_col, 8-12 packed column cache, 13-15 spare
  int32_t s[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) s[r] = A.init_state[r * sB + b];
  if (!valid) s[5] = 1;
  const int32_t base = A.win_base[b];
  const int32_t dflt = A.seq_len[b];
  const int32_t seed_v = A.seed[b];
  int t = 0;
  uint32_t word = 0;

  // the slices the lane steps in: it enters slice c live at sk == base + c
  auto needed = [&](int c) {
    return __any_sync(FULL, s[5] == 0 && s[6] == 0 && s[0] == base + c);
  };
  for (int c = A.K; c >= 1; --c) {
    if (!needed(c)) continue;
    __syncwarp();  // the lane has left the previous slice's tables
    stage(A, S, c, b, tid);
    cp_async_wait_all();
    __syncwarp();
    derive(A, S, c, b, tid, lut);
    __syncwarp();
    const int32_t q = base + c;
    for (int it = 0;; ++it) {
      const bool act = s[0] == q && s[5] == 0 && s[6] == 0 &&
                       it < A.W_cap && t < A.T_total - 1;
      if (!__any_sync(FULL, act)) break;
      const int32_t row_in = s[1], slot = s[2], off = s[3], here = s[4];
      const int si = sidx(slot);
      const int32_t obase = S.offs_c[si];
      int32_t col[5];
      if (s[7] == 1) {
        read_col(S, clamp_cell(obase + off, Cm), col);
      } else {
#pragma unroll
        for (int f = 0; f < 5; ++f) col[f] = s[8 + f];
      }
      const bool is_start = off == 0;
      const int code = ((uint32_t)col[4] >> 25) & 7;  // (e >> 1) & 7
      const int32_t mrow =
          (row_in >= 0 && row_in < 64) ? S.mrow[row_in] : 0;
      const bool matched = (mrow >> code) & 1;
      // row masks of row_in and row_in - 1, shared by every score read
      const RowMask m0 = row_mask(row_in), m1 = row_mask(row_in - 1);

      // Inside a node above row 0 (most steps) the only candidates are
      // H and D to (off - 1) and V, and no STOP: every thread of the lane
      // weighs them, without ballots or shuffles.
      int32_t u[5];
      read_col(S, clamp_cell(obase + off - 1, Cm), u);
      const int32_t h_val = masked_value(u, m0), d_val = masked_value(u, m1);
      const int32_t vert = masked_value(col, m1);
      bool take_h = h_val == here - 1;
      bool take_d = !take_h && (matched ? d_val == here : d_val == here - 1);
      const bool fast_v = !take_h && !take_d && vert == here - 1;
      int move = take_h ? 3 : (take_d ? 4 : (fast_v ? 2 : 0));
      bool decided = take_h || take_d || fast_v;
      bool spec = false, moved_down = false;
      int32_t n_slot = slot;
      int32_t n_off = decided && !fast_v ? off - 1 : off;
      int32_t n_row = take_d || fast_v ? row_in - 1 : row_in;
      int32_t n_here =
          (take_h || fast_v || (take_d && !matched)) ? here - 1 : here;
      bool take_w = take_h || take_d;  // the column moves to u's

      // A node start, row 0 or the table's first row: the reference's
      // full priority over STOP, the in-neighbours and the previous
      // slice, run when a lane of the warp needs it.
      const int32_t grow = (q - 1) * 64 + row_in;
      const bool slow = is_start || row_in == 0 || grow == 0;
      if (__any_sync(FULL, act && slow)) {
        const int32_t node_id = S.band_c[si];
        const bool spec_s =
            grow == 0 && node_id == seed_v && here >= 0 && here <= 1;

        // vertical value and the within-node row-0 diagonal: the score at
        // (slice q-1, node, off, row 63), or the synthetic initial slice
        // (the seed node at score 0) when q == 1
        int32_t vert_s = vert, wn_d = dflt;
        if (row_in == 0) {
          const int32_t m = S.map[si];
          const int32_t pbase = S.offs_p[sidx(m < 0 ? 0 : m)];
          auto prev_value = [&](int32_t o) {
            if (q == 1) return node_id == seed_v ? 0 : dflt;
            if (m < 0) return dflt;
            return S.send[clamp_cell(pbase + o, Cm)];
          };
          vert_s = prev_value(off);
          wn_d = prev_value(off - 1);
        }

        // The in-neighbours, a chunk of the lane's threads at a time (the
        // narrow route: its four threads, one chunk; the wide: the warp's
        // 32, as many chunks as it takes). The first chunk with a legal H
        // or D decides: its winner is the lowest k, H before D, and its
        // pred fields, offset and column come from its thread.
        const int lsh = WIDE ? 0 : tid & ~3;
        const unsigned lmask = WIDE ? FULL : 15u;
        const int n_chunks = WIDE && is_start ? (A.K_in + 31) >> 5 : 1;
        unsigned any4 = 0;
        bool w_h = false;  // the winner's move is H
        int kw = 0;
        int32_t w_off = 0, w_po_off = 0, wpw = 0, wppw = 0;
        int32_t w_col[5] = {0, 0, 0, 0, 0};
        for (int ch = 0; ch < n_chunks && !any4; ++ch) {
          const int k = WIDE ? (ch << 5) + tid : tid & 3;
          // this thread's in-neighbour's pred words, shifted to its field
          int32_t pw, ppw;
          if constexpr (WIDE) {
            const int pi = (k / 5) * (Nm + 1) + si;
            pw = k < A.K_in ? S.pred_c[pi] >> (6 * (k % 5)) : 0;
            ppw = k < A.K_in ? S.pprev_c[pi] >> (6 * (k % 5)) : 0;
          } else {
            pw = S.pred_c[si] >> (6 * k);
            ppw = S.pprev_c[si] >> (6 * k);
          }
          const int32_t pslot = pw & 31, psp = ppw & 31;
          const bool pvalid = (pw >> 5) & 1, ppv = (ppw >> 5) & 1;
          const int32_t u_off =
              is_start ? S.lens_c[sidx(pslot)] - 1 : off - 1;
          const bool uv =
              k == 0 ? (pvalid || !is_start) : (is_start && pvalid);
          const bool prev_only = is_start && row_in == 0 && !pvalid && ppv;
          const bool cand =
              act && slow && !spec_s && k < A.K_in && (uv || prev_only);
          int32_t us[5];
          const int32_t ubase = is_start ? S.offs_c[sidx(pslot)] : obase;
          read_col(S, clamp_cell(ubase + u_off, Cm), us);
          const bool h_ok = cand && uv && masked_value(us, m0) == here - 1;
          int32_t diag = masked_value(us, m1), po_off = dflt;
          if (row_in == 0) {
            // boundary diagonal: the pred's end cell in the previous band
            po_off = S.lens_p[sidx(psp)] - 1;
            const int cellp = clamp_cell(S.offs_p[sidx(psp)] + po_off, Cm);
            const int32_t v = q == 1 ? 0 : S.send[cellp];
            diag = is_start ? (ppv ? v : dflt) : wn_d;
          }
          const bool d_ok =
              cand && (matched ? diag == here : diag == here - 1);

          const unsigned h4 = (__ballot_sync(FULL, h_ok) >> lsh) & lmask;
          const unsigned d4 = (__ballot_sync(FULL, d_ok) >> lsh) & lmask;
          any4 = h4 | d4;
          const int lw = any4 ? __ffs(any4) - 1 : 0;
          w_h = (h4 >> lw) & 1;
          kw = (WIDE ? ch << 5 : 0) + lw;
          const int src = lsh + lw;
          w_off = __shfl_sync(FULL, u_off, src);
          w_po_off = __shfl_sync(FULL, po_off, src);
          wpw = __shfl_sync(FULL, pw, src);
          wppw = __shfl_sync(FULL, ppw, src);
#pragma unroll
          for (int f = 0; f < 5; ++f) w_col[f] = __shfl_sync(FULL, us[f], src);
        }
        if (slow) {
          const bool s_h = any4 && w_h;
          const bool s_d = any4 && !s_h;
          const bool s_v = !spec_s && !any4 && vert_s == here - 1;
          spec = spec_s;
          take_h = s_h;
          take_d = s_d;
          take_w = any4;
          decided = spec_s || any4 || s_v;
          move = spec_s ? 1
                        : s_h ? (is_start ? C_HK + kw : 3)
                              : s_d ? (is_start ? C_DK + kw : 4)
                                    : s_v ? 2 : 0;
          n_slot = any4 && is_start ? (wpw & 31) : slot;
          n_off = any4 ? w_off : off;
          n_row = spec_s || s_d || s_v ? row_in - 1 : row_in;
          n_here = (s_h || s_v || (s_d && !matched)) ? here - 1 : here;
#pragma unroll
          for (int f = 0; f < 5; ++f) u[f] = w_col[f];
          // a row-0 D or V moves down a slice; a prev-only D lands
          // directly in slice q-1 at the pred's end cell, with its
          // PREVIOUS-band slot and offset, any other at the slot of its
          // node there
          moved_down = (s_d || s_v) && row_in == 0;
          if (moved_down) {
            if (s_d && is_start && !((wpw >> 5) & 1) && ((wppw >> 5) & 1)) {
              n_slot = wppw & 31;
              n_off = w_po_off;
            } else {
              const int32_t m = S.map[sidx(n_slot)];
              n_slot = m < 0 ? 0 : m;
            }
            n_row = 63;
          }
        }
      }
      if (act) {
        s[0] -= moved_down ? 1 : 0;
        s[1] = n_row;
        s[2] = n_slot;
        s[3] = n_off;
        s[4] = n_here;
        s[5] = (spec || (q == 1 && moved_down)) ? 1 : 0;
        s[6] = decided ? 0 : 1;
        s[7] = moved_down ? 1 : 0;
#pragma unroll
        for (int f = 0; f < 5; ++f) s[8 + f] = take_w ? u[f] : col[f];
        word |= (uint32_t)move << (BITS * (t % PER));
        if (t % PER == PER - 1) {
          if (tid == 0)
            A.moves[min(t / PER, A.T_w - 1) * sB + b] = (int32_t)word;
          word = 0;
        }
        ++t;
      }
    }
  }
  if (tid == 0) {
    A.moves[min(t / PER, A.T_w - 1) * sB + b] = (int32_t)word;
    A.used[b] = t;
    // a lane still inside this window that is not done got stuck -> fail;
    // lanes with sk <= base continue in the next (earlier) window
    A.fail[b] = (s[6] == 1 || (s[5] == 0 && s[0] > base)) ? 1 : 0;
#pragma unroll
    for (int r = 0; r < 16; ++r) A.state_out[r * sB + b] = s[r];
  }
}

template <bool WIDE>
static int launch_walk_moves(const Args &A, int smem, void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      walk_moves_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  walk_moves_kernel<WIDE><<<A.B, 32, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

#define WALK_MOVES_PARAMS                                                     \
  const int32_t *cols, const int32_t *band, const int32_t *lens,             \
      const int32_t *pred, const int32_t *pprev, const uint8_t *codes,        \
      const int32_t *lut, const int32_t *seq_len, const int32_t *seed,        \
      const int32_t *win_base, const int32_t *init_state, int32_t *moves,     \
      int32_t *fail, int32_t *state_out, int32_t *used, int K, int Cm,        \
      int Nm, int B, int K_in, int W_cap, int T_total, int T_w, int R,        \
      int per, int smem, void *stream

// the narrow route: up to 4 in-neighbours, 4-bit move codes
extern "C" int ga_walk_moves(WALK_MOVES_PARAMS) {
  if (K_in < 1 || K_in > 4 || per != 8) return (int)cudaErrorInvalidValue;
  const Args A{cols, band, lens, pred, pprev, codes, lut, seq_len, seed,
               win_base, init_state, moves, fail, state_out, used, K, Cm, Nm,
               B, K_in, W_cap, T_total, T_w, R, 1, 8};
  return launch_walk_moves<false>(A, smem, stream);
}

// the wide route: past 4 in-neighbours, byte move codes up to 64 and
// 16-bit ones past
extern "C" int ga_walk_moves_wide(WALK_MOVES_PARAMS) {
  if (K_in < 5 || per != (K_in <= 64 ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  const Args A{cols, band, lens, pred, pprev, codes, lut, seq_len, seed,
               win_base, init_state, moves, fail, state_out, used, K, Cm, Nm,
               B, K_in, W_cap, T_total, T_w, R, (K_in + 4) / 5, per};
  return launch_walk_moves<true>(A, smem, stream);
}
