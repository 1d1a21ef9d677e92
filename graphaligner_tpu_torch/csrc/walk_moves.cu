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
// The wide route (walk_moves_wide_kernel, past 4 in-neighbours) computes
// what the JAX package runs there, its XLA walk (graphaligner_tpu/core/
// backtrace_device.py::walk_batch), with the same priority, on tables
// laid out lane-major ([K+1, B, 7, Cm] columns, [K+1, B, *] the others),
// so that a lane's slice is seven contiguous runs of Cm words. Its moves
// are byte codes, four an int32 word (0 PAD, 1 STOP, 2 V, 3 H, 4 D, 64+k
// Hk, 128+k Dk), up to 64 in-neighbours, and 16-bit codes, two a word
// (0x4000+k Hk, 0x8000+k Dk), past 64; the codes a word are a template
// parameter (shifts, not divisions). The caller gives it walk_batch's
// budget (T_total - 1 steps, W_cap no tighter). Its design, from a clock
// split of the parent design (which staged the lane-last table a 4-byte
// word at a time, each its own 32-byte sector, and weighed every
// in-neighbour in chunks of 32 at a node start):
// - Staging: the warp copies a slice's runs with 16-byte cp.async.cg,
//   coalesced, into one of two slice buffers; while the lane walks slice
//   c, slice c - 1 (the only one it can enter next) lands in the other.
//   The two take 130,304 bytes at Cm=2304, the top capacity tier.
// - Fields planar in shared memory ([6][Cm] then send [Cm]).
// - Node-start candidate lists: after a slice lands, slot thread j reads
//   its pred and pred_prev planes from device memory (coalesced over the
//   warp) and keeps, in k order, the in-neighbours that can be candidates
//   (in band, or prev-only for row 0), each with its 6-bit fields, up to
//   32 (a chunk). A node start then weighs one chunk of its list: thread
//   i its i-th entry, two ballots, the lowest set bit the lowest k, H
//   before D. A slot with more than 32 candidates (many prev-only ones or
//   a repeated in-neighbour) weighs its whole row instead, 32 in-neighbours
//   a chunk read from device memory, the first chunk with a legal move
//   deciding, as the parent did. In-neighbour 0 keeps its role as the
//   within-node move: off a node start it is the fast path's column.
// So its shared bytes do not grow with the in-degree, and every lane's
// state is the same in all 32 threads: the loops need no votes. What
// bounds it is the narrow route's: the integer work of the steps, 0.023 ms
// at K_in=80 (converging's widest call, K=160, Cm=1152, B=384) and 0.039
// ms at K_in=8 (multiallelic's, Cm=576, B=512), against each lane's chain
// of about 10,000 dependent steps: 3.42 to 3.44 ms (339 to 341 ns a
// step) and 3.23 to 3.25 ms (320 to 322 ns), the parent design 13.8 and
// 8.7 ms in turns, the step's head (the fast path) half of it; NVIDIA
// H100 80GB HBM3, 700 W, compare_k1_proj.py.
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

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Args {
  const int32_t *cols;  // [K+1, 7, Cm, B]; wide: [K+1, B, 7, Cm]
  // [K+1, Nm, B] (pred, pprev [K+1, NP * Nm, B]); wide: lanes second
  const int32_t *band, *lens, *pred, *pprev;
  const uint8_t *codes;  // [K+1, 64, B]; wide: [K+1, B, 64]
  const int32_t *lut;  // [R] read code -> match mask
  const int32_t *seq_len, *seed, *win_base;  // [1, B]
  const int32_t *init_state;  // [16, B]
  int32_t *moves;  // [T_w, B], zero on entry
  int32_t *fail, *state_out, *used;  // [1, B], [16, B], [1, B]
  int K, Cm, Nm, B, K_in, W_cap, T_total, T_w, R;
  int NP;  // pred planes a slot
};

// The block's lane's tables of one slice (the narrow route).
struct Buf {
  int32_t *cols;  // [Cm][6]: fields 0-4 of cur's cells, then e (field 6)
  int32_t *send;  // [Cm]: field 5 of the previous slice
  int32_t *band_c, *lens_c, *pred_c, *pprev_c, *band_p, *lens_p;  // [Nm+1]
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
  S.pprev_c = S.pred_c + n;
  S.band_p = S.pprev_c + n;
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
  const int32_t *tab_src[6] = {A.band, A.lens, A.pred, A.pprev, A.band,
                               A.lens};
  int32_t *tab_dst[6] = {S.band_c, S.lens_c, S.pred_c, S.pprev_c, S.band_p,
                         S.lens_p};
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const int sl = a < 4 ? c : c - 1;
    if (tid < Nm)
      cp_async4(tab_dst[a] + tid,
                tab_src[a] + ((size_t)sl * Nm + tid) * sB + b);
  }
  // codes: the aligned word that holds the lane's byte, one a row
  for (int r = tid; r < 64; r += 32)
    cp_async4(S.mrow + r,
              (const void *)(code_addr(A, c, r, b) & ~(uintptr_t)3));
}

// The exclusive prefix offsets of a band's lens (a warp scan, a slot a
// thread), entry Nm 0.
__device__ __forceinline__ void prefix_offsets(const int32_t *lens,
                                               int32_t *offs, int Nm,
                                               int tid) {
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

// After slice c's copies landed: the prefix offsets of both bands, the
// slot map and the match masks.
__device__ void derive(const Args &A, const Buf &S, int c, int b, int tid,
                       const int32_t *lut) {
  const int Nm = A.Nm;
  prefix_offsets(S.lens_c, S.offs_c, Nm, tid);
  prefix_offsets(S.lens_p, S.offs_p, Nm, tid);
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

// The narrow route: one lane a block (one warp), threads 0-3 walking it
// (thread k weighing in-neighbour k), the whole warp staging and deriving
// its slices. Threads 4-31 step with the lane's tables on an idle state
// (done), so every warp collective has all 32 threads.
__global__ void __launch_bounds__(32) walk_moves_kernel(Args A) {
  extern __shared__ __align__(16) int32_t smem[];
  const int tid = threadIdx.x;
  const int Cm = A.Cm, Nm = A.Nm;
  const int b = blockIdx.x;
  const bool valid = tid < 4;
  const size_t sB = (size_t)A.B;
  auto sidx = [&](int32_t slot) { return (slot >= 0 && slot < Nm) ? slot : Nm; };

  int32_t *lut = smem;
  for (int r = tid; r < A.R; r += 32) lut[r] = A.lut[r];
  const Buf S = buf_at(smem + ((A.R + 3) & ~3), A);
  if (tid == 0) {  // the out-of-range slot reads 0
    S.band_c[Nm] = 0;
    S.lens_c[Nm] = 0;
    S.lens_p[Nm] = 0;
    S.pred_c[Nm] = 0;
    S.pprev_c[Nm] = 0;
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

        // The in-neighbours, one a thread of the lane's four: a legal H
        // or D decides, its winner the lowest k, H before D, its pred
        // fields, offset and column from its thread.
        const int lsh = tid & ~3;
        const int k = tid & 3;
        // this thread's in-neighbour's pred words, shifted to its field
        const int32_t pw = S.pred_c[si] >> (6 * k);
        const int32_t ppw = S.pprev_c[si] >> (6 * k);
        const int32_t pslot = pw & 31, psp = ppw & 31;
        const bool pvalid = (pw >> 5) & 1, ppv = (ppw >> 5) & 1;
        const int32_t u_off = is_start ? S.lens_c[sidx(pslot)] - 1 : off - 1;
        const bool uv = k == 0 ? (pvalid || !is_start) : (is_start && pvalid);
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
        const bool d_ok = cand && (matched ? diag == here : diag == here - 1);

        const unsigned h4 = (__ballot_sync(FULL, h_ok) >> lsh) & 15u;
        const unsigned d4 = (__ballot_sync(FULL, d_ok) >> lsh) & 15u;
        const unsigned any4 = h4 | d4;
        const int kw = any4 ? __ffs(any4) - 1 : 0;
        const bool w_h = (h4 >> kw) & 1;
        const int src = lsh + kw;
        const int32_t w_off = __shfl_sync(FULL, u_off, src);
        const int32_t w_po_off = __shfl_sync(FULL, po_off, src);
        const int32_t wpw = __shfl_sync(FULL, pw, src);
        const int32_t wppw = __shfl_sync(FULL, ppw, src);
        int32_t w_col[5];
#pragma unroll
        for (int f = 0; f < 5; ++f) w_col[f] = __shfl_sync(FULL, us[f], src);
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
                        : s_h ? (is_start ? 8 + kw : 3)
                              : s_d ? (is_start ? 12 + kw : 4)
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
        word |= (uint32_t)move << (4 * (t % 8));
        if (t % 8 == 7) {
          if (tid == 0) A.moves[min(t / 8, A.T_w - 1) * sB + b] = (int32_t)word;
          word = 0;
        }
        ++t;
      }
    }
  }
  if (tid == 0) {
    A.moves[min(t / 8, A.T_w - 1) * sB + b] = (int32_t)word;
    A.used[b] = t;
    // a lane still inside this window that is not done got stuck -> fail;
    // lanes with sk <= base continue in the next (earlier) window
    A.fail[b] = (s[6] == 1 || (s[5] == 0 && s[0] > base)) ? 1 : 0;
#pragma unroll
    for (int r = 0; r < 16; ++r) A.state_out[r * sB + b] = s[r];
  }
}

namespace {

constexpr int LCAP = 32;  // node-start candidates a slot's list holds

// A wide slice buffer: what cp.async stages for slice c.
struct WBuf {
  int32_t *f;  // [6][Cm]: fields 0-4 of c's cells, then e (field 6)
  int32_t *send;  // [Cm]: field 5 of slice c - 1
  int32_t *band_c, *lens_c, *band_p, *lens_p;  // [NB] (entry Nm: 0)
  int32_t *codes;  // [16]: the lane's 64 code bytes of slice c
};

// What the warp derives from a landed slice before walking it.
struct Derived {
  int32_t *offs_c, *offs_p, *map, *cnt;  // [NB]
  int32_t *mrow;  // [64] match masks
  uint32_t *list;  // [Nm][LCAP]: k | pred field << 16 | pred_prev << 22
};

// words of a slot table, a multiple of 4 so that buffers stay 16-aligned
__host__ __device__ __forceinline__ int slot_words(int Nm) {
  return (Nm + 4) & ~3;
}

__host__ __device__ __forceinline__ int wbuf_words(int Cm, int Nm) {
  return 7 * Cm + 4 * slot_words(Nm) + 16;
}

__device__ __forceinline__ WBuf wbuf_at(int32_t *smem, const Args &A,
                                        int i) {
  const int NB = slot_words(A.Nm);
  WBuf S;
  S.f = smem + i * wbuf_words(A.Cm, A.Nm);
  S.send = S.f + 6 * A.Cm;
  S.band_c = S.send + A.Cm;
  S.lens_c = S.band_c + NB;
  S.band_p = S.lens_c + NB;
  S.lens_p = S.band_p + NB;
  S.codes = S.lens_p + NB;
  return S;
}

__device__ __forceinline__ Derived derived_at(int32_t *smem, const Args &A) {
  const int NB = slot_words(A.Nm);
  Derived D;
  D.offs_c = smem + 2 * wbuf_words(A.Cm, A.Nm);
  D.offs_p = D.offs_c + NB;
  D.map = D.offs_p + NB;
  D.cnt = D.map + NB;
  D.mrow = D.cnt + NB;
  D.list = (uint32_t *)(D.mrow + 64);
  return D;
}

// Issue and commit the copies of slice c (c >= 1) for lane b: seven runs of
// Cm words in 16-byte pieces over the warp, a band-table word a thread and
// the 64 code bytes.
__device__ void stage_wide(const Args &A, const WBuf &S, int c, int b,
                           int tid) {
  const int Cm = A.Cm, Nm = A.Nm, n16 = Cm >> 2;
  const int32_t *lane = A.cols + ((size_t)c * A.B + b) * 7 * Cm;
  const int32_t *below = A.cols + ((size_t)(c - 1) * A.B + b) * 7 * Cm;
#pragma unroll
  for (int f = 0; f < 7; ++f) {
    // fields 0-4 and 6 of slice c, then field 5 of slice c - 1
    const int32_t *src = f < 5 ? lane + f * Cm
                               : (f == 5 ? lane + 6 * Cm : below + 5 * Cm);
    int32_t *dst = S.f + f * Cm;
    for (int x = tid; x < n16; x += 32) cp_async16(dst + 4 * x, src + 4 * x);
  }
  if (tid < Nm) {
    const size_t cur = ((size_t)c * A.B + b) * Nm + tid;
    const size_t prv = ((size_t)(c - 1) * A.B + b) * Nm + tid;
    cp_async4(S.band_c + tid, A.band + cur);
    cp_async4(S.lens_c + tid, A.lens + cur);
    cp_async4(S.band_p + tid, A.band + prv);
    cp_async4(S.lens_p + tid, A.lens + prv);
  }
  if (tid < 4)
    cp_async16(S.codes + 4 * tid, A.codes + ((size_t)c * A.B + b) * 64 +
                                      16 * tid);
  cp_async_commit();
}

constexpr int PLANES_IN_FLIGHT = 8;  // pred planes a slot thread loads at once

// Pred and pred_prev planes p0 to p0 + PLANES_IN_FLIGHT - 1 of slot thread
// tid (0 past NP), their loads issued together.
__device__ __forceinline__ void load_planes(const Args &A, size_t row,
                                            int p0,
                                            uint32_t (&pw)[PLANES_IN_FLIGHT],
                                            uint32_t (&qw)[PLANES_IN_FLIGHT]) {
#pragma unroll
  for (int i = 0; i < PLANES_IN_FLIGHT; ++i) {
    const bool in = p0 + i < A.NP;
    const size_t at = row + (size_t)(p0 + i) * A.Nm;
    pw[i] = in ? (uint32_t)__ldg(A.pred + at) : 0u;
    qw[i] = in ? (uint32_t)__ldg(A.pprev + at) : 0u;
  }
}

// After slice c landed in S: the prefix offsets of both bands, the slot
// map, the match masks and each slot's node-start candidate list (whose
// first planes' loads are in flight while the rest is derived).
__device__ void derive_wide(const Args &A, const WBuf &S, const Derived &D,
                            int c, int b, int tid) {
  const int Nm = A.Nm;
  const size_t row = ((size_t)c * A.B + b) * A.NP * Nm + tid;
  uint32_t pw[PLANES_IN_FLIGHT], qw[PLANES_IN_FLIGHT];
  if (tid < Nm) load_planes(A, row, 0, pw, qw);
  prefix_offsets(S.lens_c, D.offs_c, Nm, tid);
  prefix_offsets(S.lens_p, D.offs_p, Nm, tid);
  // the map: slot j's node among the previous band's ids below GA_EMPTY
  // (summed over equal ids), -1 when absent; entry Nm maps node 0
  const int32_t idp = tid < Nm ? S.band_p[tid] : GA_EMPTY;
  const int32_t node = tid < Nm ? S.band_c[tid] : 0;
  int32_t ps = 0;
  bool found = false;
  for (int i = 0; i < Nm; ++i) {
    const int32_t id = __shfl_sync(FULL, idp, i);
    const bool m = id == node && id < GA_EMPTY;
    ps += m ? i : 0;
    found |= m;
  }
  if (tid < Nm) D.map[tid] = found ? ps : -1;
  const unsigned zeros = __ballot_sync(FULL, idp == 0);
  if (tid == 0) {
    int32_t z = 0;
    for (unsigned x = zeros; x; x &= x - 1) z += __ffs(x) - 1;
    D.map[Nm] = zeros ? z : -1;
  }
  const uint8_t *codes = (const uint8_t *)S.codes;
  for (int r = tid; r < 64; r += 32) {
    const int code = codes[r];
    D.mrow[r] = code < A.R ? __ldg(A.lut + code) : 0;
  }
  // slot j's candidates in k order: in band (pred valid), or prev-only
  // (pred_prev valid; a candidate at row 0 only), with their fields
  if (tid < Nm) {
    uint32_t *list = D.list + tid * LCAP;
    int n = 0;
    for (int p0 = 0;;) {
#pragma unroll
      for (int i = 0; i < PLANES_IN_FLIGHT; ++i) {
        if (!((pw[i] | qw[i]) & 0x20820820u)) continue;  // no valid field
        for (int f = 0; f < 5; ++f) {
          const int k = 5 * (p0 + i) + f;
          const uint32_t fp = (pw[i] >> (6 * f)) & 63;
          const uint32_t fq = (qw[i] >> (6 * f)) & 63;
          if (k < A.K_in && ((fp | fq) & 32)) {
            if (n < LCAP) list[n] = (uint32_t)k | fp << 16 | fq << 22;
            ++n;
          }
        }
      }
      p0 += PLANES_IN_FLIGHT;
      if (p0 >= A.NP) break;
      load_planes(A, row, p0, pw, qw);
    }
    D.cnt[tid] = n;
  }
}

// the packed column of a cell from the planar fields
__device__ __forceinline__ void read_col_wide(const WBuf &S, int Cm, int cell,
                                              int32_t (&w)[5]) {
  const int32_t *p = S.f + cell;
#pragma unroll
  for (int f = 0; f < 4; ++f) w[f] = p[f * Cm];
  w[4] = (int32_t)(((uint32_t)p[4 * Cm] & 0xFFFFFFu) |
                   ((uint32_t)p[5 * Cm] << 24));
}

}  // namespace

// The wide route: one lane a block (one warp), every thread holding the
// lane's state, thread i weighing the i-th entry of a node start's chunk
// of candidates. PER move codes an int32 word (4 or 2).
template <int PER>
__global__ void __launch_bounds__(32) walk_moves_wide_kernel(Args A) {
  extern __shared__ __align__(16) int32_t smem[];
  constexpr int BITS = 32 / PER;
  constexpr int C_HK = PER == 4 ? 64 : 0x4000;
  constexpr int C_DK = PER == 4 ? 128 : 0x8000;
  const int tid = threadIdx.x;
  const int Cm = A.Cm, Nm = A.Nm;
  const int b = blockIdx.x;
  const size_t sB = (size_t)A.B;
  auto sidx = [&](int32_t slot) { return (slot >= 0 && slot < Nm) ? slot : Nm; };
  const Derived D = derived_at(smem, A);
  if (tid == 0) {  // the out-of-range slot reads 0 and has no candidates
    for (int i = 0; i < 2; ++i) {
      const WBuf S = wbuf_at(smem, A, i);
      S.band_c[Nm] = 0;
      S.lens_c[Nm] = 0;
      S.lens_p[Nm] = 0;
    }
    D.cnt[Nm] = 0;
  }

  // lane state, the same in every thread: 0 sk, 1 row_in, 2 slot, 3 off,
  // 4 here, 5 done, 6 fail, 7 needs_col, 8-12 packed column cache
  int32_t s[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) s[r] = A.init_state[r * sB + b];
  const int32_t base = A.win_base[b];
  const int32_t dflt = A.seq_len[b];
  const int32_t seed_v = A.seed[b];
  int t = 0;
  uint32_t word = 0;

  // the lane enters slice c live at sk == base + c, the top one first
  int c = s[0] - base;
  const bool live = s[5] == 0 && s[6] == 0 && c >= 1 && c <= A.K;
  if (live) stage_wide(A, wbuf_at(smem, A, c & 1), c, b, tid);
  for (; live && c >= 1; --c) {
    const WBuf S = wbuf_at(smem, A, c & 1);
    if (c >= 2) {
      // slice c - 1 lands in the other buffer while the lane walks c
      __syncwarp();
      stage_wide(A, wbuf_at(smem, A, (c - 1) & 1), c - 1, b, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    derive_wide(A, S, D, c, b, tid);
    __syncwarp();
    const int32_t q = base + c;
    for (int it = 0;; ++it) {
      if (!(s[0] == q && s[5] == 0 && s[6] == 0 && it < A.W_cap &&
            t < A.T_total - 1))
        break;
      const int32_t row_in = s[1], slot = s[2], off = s[3], here = s[4];
      const int si = sidx(slot);
      const int32_t obase = D.offs_c[si];
      int32_t col[5];
      if (s[7] == 1) {
        read_col_wide(S, Cm, clamp_cell(obase + off, Cm), col);
      } else {
#pragma unroll
        for (int f = 0; f < 5; ++f) col[f] = s[8 + f];
      }
      const bool is_start = off == 0;
      const int code = ((uint32_t)col[4] >> 25) & 7;  // (e >> 1) & 7
      const int32_t mrow =
          (row_in >= 0 && row_in < 64) ? D.mrow[row_in] : 0;
      const bool matched = (mrow >> code) & 1;
      const RowMask m0 = row_mask(row_in), m1 = row_mask(row_in - 1);

      // inside a node above row 0: H and D to (off - 1), then V
      int32_t u[5];
      read_col_wide(S, Cm, clamp_cell(obase + off - 1, Cm), u);
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

      // a node start, row 0 or the table's first row: the full priority
      const int32_t grow = (q - 1) * 64 + row_in;
      if (is_start || row_in == 0 || grow == 0) {
        const int32_t node_id = S.band_c[si];
        const bool spec_s =
            grow == 0 && node_id == seed_v && here >= 0 && here <= 1;
        int32_t vert_s = vert, wn_d = dflt;
        if (row_in == 0) {
          const int32_t m = D.map[si];
          const int32_t pbase = D.offs_p[sidx(m < 0 ? 0 : m)];
          auto prev_value = [&](int32_t o) {
            if (q == 1) return node_id == seed_v ? 0 : dflt;
            if (m < 0) return dflt;
            return S.send[clamp_cell(pbase + o, Cm)];
          };
          vert_s = prev_value(off);
          wn_d = prev_value(off - 1);
        }

        bool any = false, w_h = false;  // a legal H or D; the winner's is H
        int32_t kw = 0, w_off = off - 1, w_po_off = 0, wpw = 0, wppw = 0;
        int32_t w_col[5];
#pragma unroll
        for (int f = 0; f < 5; ++f) w_col[f] = u[f];
        if (!is_start) {
          // in-neighbour 0 alone, the within-node move to u
          const int32_t diag = row_in == 0 ? wn_d : d_val;
          w_h = !spec_s && h_val == here - 1;
          any = w_h || (!spec_s && (matched ? diag == here : diag == here - 1));
        } else {
          // a chunk of candidates at a time: the slot's list (one chunk),
          // or past LCAP its whole row from device memory
          const int n = D.cnt[si];
          const bool listed = n <= LCAP;
          const int n_chunks = listed ? (n > 0) : (A.K_in + 31) >> 5;
          for (int ch = 0; ch < n_chunks && !any; ++ch) {
            int32_t k, pw, ppw;
            bool in;
            if (listed) {
              in = tid < n;
              const uint32_t e = in ? D.list[si * LCAP + tid] : 0;
              k = e & 0xFFFF;
              pw = (e >> 16) & 63;
              ppw = (e >> 22) & 63;
            } else {
              k = (ch << 5) + tid;
              in = k < A.K_in;
              const int p = k / 5, sh = 6 * (k - 5 * p);
              const size_t at =
                  (((size_t)c * A.B + b) * A.NP + p) * Nm + si;
              pw = in ? (__ldg(A.pred + at) >> sh) & 63 : 0;
              ppw = in ? (__ldg(A.pprev + at) >> sh) & 63 : 0;
            }
            const int32_t pslot = pw & 31, psp = ppw & 31;
            const bool pvalid = (pw >> 5) & 1, ppv = (ppw >> 5) & 1;
            const int32_t u_off = S.lens_c[sidx(pslot)] - 1;
            const bool prev_only = row_in == 0 && !pvalid && ppv;
            const bool cand = in && !spec_s && (pvalid || prev_only);
            int32_t us[5];
            read_col_wide(S, Cm, clamp_cell(D.offs_c[sidx(pslot)] + u_off, Cm),
                          us);
            const bool h_ok = cand && pvalid && masked_value(us, m0) == here - 1;
            int32_t diag = masked_value(us, m1), po_off = dflt;
            if (row_in == 0) {
              // boundary diagonal: the pred's end cell in the previous band
              po_off = S.lens_p[sidx(psp)] - 1;
              const int cellp = clamp_cell(D.offs_p[sidx(psp)] + po_off, Cm);
              diag = ppv ? (q == 1 ? 0 : S.send[cellp]) : dflt;
            }
            const bool d_ok =
                cand && (matched ? diag == here : diag == here - 1);
            const unsigned hb = __ballot_sync(FULL, h_ok);
            const unsigned ab = hb | __ballot_sync(FULL, d_ok);
            any = ab != 0;
            const int lw = any ? __ffs(ab) - 1 : 0;
            w_h = (hb >> lw) & 1;
            kw = __shfl_sync(FULL, k, lw);
            w_off = __shfl_sync(FULL, u_off, lw);
            w_po_off = __shfl_sync(FULL, po_off, lw);
            wpw = __shfl_sync(FULL, pw, lw);
            wppw = __shfl_sync(FULL, ppw, lw);
#pragma unroll
            for (int f = 0; f < 5; ++f) w_col[f] = __shfl_sync(FULL, us[f], lw);
          }
        }
        const bool s_h = any && w_h;
        const bool s_d = any && !s_h;
        const bool s_v = !spec_s && !any && vert_s == here - 1;
        spec = spec_s;
        take_h = s_h;
        take_d = s_d;
        take_w = any;
        decided = spec_s || any || s_v;
        move = spec_s ? 1
                      : s_h ? (is_start ? C_HK + kw : 3)
                            : s_d ? (is_start ? C_DK + kw : 4)
                                  : s_v ? 2 : 0;
        n_slot = any && is_start ? (wpw & 31) : slot;
        n_off = any ? w_off : off;
        n_row = spec_s || s_d || s_v ? row_in - 1 : row_in;
        n_here = (s_h || s_v || (s_d && !matched)) ? here - 1 : here;
#pragma unroll
        for (int f = 0; f < 5; ++f) u[f] = w_col[f];
        // a row-0 D or V moves down a slice; a prev-only D lands directly
        // in slice q-1 at the pred's end cell, with its PREVIOUS-band slot
        // and offset, any other at the slot of its node there
        moved_down = (s_d || s_v) && row_in == 0;
        if (moved_down) {
          if (s_d && is_start && !((wpw >> 5) & 1) && ((wppw >> 5) & 1)) {
            n_slot = wppw & 31;
            n_off = w_po_off;
          } else {
            const int32_t m = D.map[sidx(n_slot)];
            n_slot = m < 0 ? 0 : m;
          }
          n_row = 63;
        }
      }
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
      const unsigned ut = t;  // PER a power of two: shifts and masks
      word |= (uint32_t)move << (BITS * (ut % PER));
      if (ut % PER == PER - 1) {
        if (tid == 0)
          A.moves[min((int)(ut / PER), A.T_w - 1) * sB + b] = (int32_t)word;
        word = 0;
      }
      ++t;
    }
    if (s[0] != q - 1 || s[5] != 0 || s[6] != 0) break;  // not moved down
  }
  cp_async_wait<0>();  // a slice staged for nothing
  if (tid == 0) {
    A.moves[min((int)((unsigned)t / PER), A.T_w - 1) * sB + b] =
        (int32_t)word;
    A.used[b] = t;
    // a lane still inside this window that is not done got stuck -> fail;
    // lanes with sk <= base continue in the next (earlier) window
    A.fail[b] = (s[6] == 1 || (s[5] == 0 && s[0] > base)) ? 1 : 0;
#pragma unroll
    for (int r = 0; r < 16; ++r) A.state_out[r * sB + b] = s[r];
  }
}

namespace {

template <typename Kernel>
int launch(Kernel kernel, const Args &A, int smem, void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<A.B, 32, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

}  // namespace

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
               B, K_in, W_cap, T_total, T_w, R, 1};
  return launch(walk_moves_kernel, A, smem, stream);
}

// the wide route: past 4 in-neighbours, lane-major tables, byte move codes
// up to 64 and 16-bit ones past
extern "C" int ga_walk_moves_wide(WALK_MOVES_PARAMS) {
  if (K_in < 5 || K_in > 0x4000 || per != (K_in <= 64 ? 4 : 2) ||
      Cm % 4 != 0 || Nm > 32)
    return (int)cudaErrorInvalidValue;
  const Args A{cols, band, lens, pred, pprev, codes, lut, seq_len, seed,
               win_base, init_state, moves, fail, state_out, used, K, Cm, Nm,
               B, K_in, W_cap, T_total, T_w, R, (K_in + 4) / 5};
  return per == 4 ? launch(walk_moves_wide_kernel<4>, A, smem, stream)
                  : launch(walk_moves_wide_kernel<2>, A, smem, stream);
}
