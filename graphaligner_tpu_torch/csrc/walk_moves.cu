// Backtrace walk emitting 4-bit move codes (kernel K2) for Hopper, sm_90a.
//
// Replaces graphaligner_tpu/ops/pallas/walk_moves.py::walk_moves_kernel:
// from each lane's start (slice, slot, offset, score) the walk descends
// the DP table with the reference's predecessor priority (row-0 STOP on
// the seed node, then per in-neighbour H then D, then V), including the
// row-0 diagonal into predecessors present only in the previous band
// (pred_prev), and emits one move nibble per step, 8 per int32 word.
//
// Design: one thread per lane, each walking on its own and reading the
// packed columns straight from global memory (the TPU kernel DMA'd whole
// slices into VMEM and read them through one-hot sums; none of that VMEM
// sizing is carried over, so any Cm walks). The window semantics are kept
// (win_base, init_state in, state_out out) so a windowed long-read walk
// can chain calls; the whole-table walk is one window with base 0.
//
// Budgets: the TPU kernel walks a block of lanes in lockstep and shares
// one step budget per block (T_total = 112 K + 512 steps in all, W_cap
// steps per slice). Here each lane has its own budget of the same sizes,
// and a lane emits no PAD nibbles while other lanes step, so its raw move
// words differ from the lockstep kernel's; the decoder skips PAD per lane
// and the decoded traces agree.
//
// What bounds it: the walk reads only the columns along each lane's path,
// a small part of the [K+1, 7, Cm, B] table. Counted from the walk that ran
// at K=160, Cm=288, B=256 (chip_smoke.py), its floor is the integer work,
// 0.26 G int32 operations, 0.015 ms at the int32 issue rate, above the
// 45 MB of columns, codes, band words and outputs it needs, 0.014 ms at
// 3.35 TB/s — but the kernel takes about 21 ms there (NVIDIA H100 80GB
// HBM3, 700 W), a share of 0.0007: the serial dependence of each walk step
// on the last, and dependent scattered 4-byte loads of columns (L2
// latency), with 8 warps in all at B=256. Keeping a slice's tables in
// shared memory is later work.
#include <cuda_runtime.h>

#include "wordops.cuh"

namespace {

struct Tabs {
  const int32_t *cols6, *band, *lens, *pred, *pprev, *mtab;
  int Cm, Nm, B;
  __device__ __forceinline__ int32_t col(int q, int f, int cell, int b) const {
    return cols6[(((size_t)q * 6 + f) * Cm + cell) * B + b];
  }
  __device__ __forceinline__ int32_t nm(const int32_t *t, int q, int slot,
                                        int b) const {
    // a one-hot read over the Nm slots: out-of-range slots read 0
    if (slot < 0 || slot >= Nm) return 0;
    return t[((size_t)q * Nm + slot) * B + b];
  }
};

struct PCol {  // packed walk column: 4 word halves + (sbs | e << 24)
  int32_t w[5];
};

__device__ __forceinline__ PCol read_col(const Tabs &T, int q, int cell,
                                         int b) {
  cell = cell < 0 ? 0 : (cell > T.Cm - 1 ? T.Cm - 1 : cell);
  PCol c;
  for (int f = 0; f < 5; ++f) c.w[f] = T.col(q, f, cell, b);
  return c;
}

__device__ __forceinline__ int32_t value_at(const PCol &c, int32_t r) {
  return col_value(ga_u64(c.w[0], c.w[1]), ga_u64(c.w[2], c.w[3]),
                   c.w[4] & 0xFFFFFF, r);
}

}  // namespace

__global__ void walk_moves_kernel(
    const int32_t *__restrict__ cols6,   // [K+1, 6, Cm, B]
    const int32_t *__restrict__ band,    // [K+1, Nm, B]
    const int32_t *__restrict__ lens,    // [K+1, Nm, B]
    const int32_t *__restrict__ pred,    // [K+1, Nm, B]
    const int32_t *__restrict__ pprev,   // [K+1, Nm, B]
    const int32_t *__restrict__ mtab,    // [K+1, 64, B]
    const int32_t *__restrict__ seq_len, // [1, B]
    const int32_t *__restrict__ seed,    // [1, B]
    const int32_t *__restrict__ win_base, // [1, B]
    const int32_t *__restrict__ init_state, // [16, B]
    int32_t *__restrict__ moves,         // [T_w, B]
    int32_t *__restrict__ fail_out,      // [1, B]
    int32_t *__restrict__ state_out,     // [16, B]
    int32_t *__restrict__ used_out,      // [1, B]
    int K, int Cm, int Nm, int B, int K_in, int W_cap, int T_total,
    int T_w) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  Tabs T{cols6, band, lens, pred, pprev, mtab, Cm, Nm, B};
  for (int w = 0; w < T_w; ++w) moves[w * sB + b] = 0;
  int32_t s[16];
  for (int r = 0; r < 16; ++r) s[r] = init_state[r * sB + b];
  // rows: 0 sk, 1 row_in, 2 slot, 3 off, 4 here, 5 done, 6 fail,
  // 7 needs_col, 8-12 packed column cache, 13-15 spare
  const int32_t base = win_base[b];
  const int32_t dflt = seq_len[b];
  const int32_t seed_v = seed[b];
  int t = 0;
  uint32_t word = 0;
  int32_t offs_c[32], offs_p[32];

  for (int si = 0; si < K; ++si) {
    const int cur = K - si, prv = cur - 1;
    const int32_t q = base + cur;
    if (!(s[0] == q && s[5] == 0 && s[6] == 0)) continue;
    int32_t acc_c = 0, acc_p = 0;
    for (int j = 0; j < Nm; ++j) {
      offs_c[j] = acc_c;
      offs_p[j] = acc_p;
      acc_c += lens[((size_t)cur * Nm + j) * sB + b];
      acc_p += lens[((size_t)prv * Nm + j) * sB + b];
    }
    auto offs_cur = [&](int slot) {
      return (slot >= 0 && slot < Nm) ? offs_c[slot] : 0;
    };
    auto offs_prv = [&](int slot) {
      return (slot >= 0 && slot < Nm) ? offs_p[slot] : 0;
    };
    // slot of node `nid` in the previous band (summed like the one-hot
    // read: band ids are unique, an absent node gives slot 0)
    auto prev_slot_of = [&](int32_t nid, bool &found) {
      int32_t ps = 0;
      found = false;
      for (int j = 0; j < Nm; ++j) {
        const int32_t id = T.nm(band, prv, j, b);
        if (id == nid && id < GA_EMPTY) {
          ps += j;
          found = true;
        }
      }
      return ps;
    };
    // score at (slice q-1, node, off, row 63), or the synthetic initial
    // slice (the seed node at score 0) when q == 1
    auto prev_value = [&](int32_t nid, int32_t off) {
      if (q == 1) return nid == seed_v ? 0 : dflt;
      bool found;
      const int32_t ps = prev_slot_of(nid, found);
      if (!found) return dflt;
      int cell = offs_prv(ps) + off;
      cell = cell < 0 ? 0 : (cell > Cm - 1 ? Cm - 1 : cell);
      return T.col(prv, 5, cell, b);
    };

    for (int it = 0; s[0] == q && s[5] == 0 && s[6] == 0 && it < W_cap &&
                     t < T_total - 1;
         ++it) {
      const int32_t row_in = s[1], slot = s[2], off = s[3], here = s[4];
      PCol col;
      if (s[7] == 1) {
        col = read_col(T, cur, offs_cur(slot) + off, b);
      } else {
        for (int f = 0; f < 5; ++f) col.w[f] = s[8 + f];
      }
      const int32_t node_id = T.nm(band, cur, slot, b);
      const bool is_start = off == 0;
      const int32_t grow = (q - 1) * 64 + row_in;
      const int code = ((uint32_t)col.w[4] >> 25) & 7;  // (e >> 1) & 7
      const int32_t mrow =
          (row_in >= 0 && row_in < 64) ? mtab[((size_t)cur * 64 + row_in) * sB + b] : 0;
      const bool matched = (mrow >> code) & 1;

      // row-0 free-start stop
      const bool spec = grow == 0 && node_id == seed_v && here >= 0 && here <= 1;
      bool decided = spec;
      int move = spec ? 1 : 0;
      int32_t n_slot = slot, n_off = off, n_here = here;
      int32_t n_row = spec ? row_in - 1 : row_in;
      PCol n_col = col;
      const int32_t predw = T.nm(pred, cur, slot, b);
      const int32_t predprevw = T.nm(pprev, cur, slot, b);

      // boundary (row 0) values from the previous slice
      int32_t bd[5], po_offs[4];
      for (int k = 0; k <= K_in; ++k) bd[k] = dflt;
      for (int k = 0; k < K_in; ++k) po_offs[k] = dflt;
      if (row_in == 0) {
        const int32_t wn_d = prev_value(node_id, off - 1);
        for (int k = 0; k < K_in; ++k) {
          const int psp = (predprevw >> (6 * k)) & 31;
          const bool ppv = (predprevw >> (6 * k + 5)) & 1;
          const int32_t off_pk = T.nm(lens, prv, psp, b) - 1;
          int cellp = offs_prv(psp) + off_pk;
          cellp = cellp < 0 ? 0 : (cellp > Cm - 1 ? Cm - 1 : cellp);
          const int32_t v = q == 1 ? 0 : T.col(prv, 5, cellp, b);
          const int32_t sv = ppv ? v : dflt;
          bd[k] = is_start ? sv : wn_d;
          po_offs[k] = off_pk;
        }
        bd[K_in] = prev_value(node_id, off);
      }

      bool po_any = false;
      int32_t po_slot = 0, po_off = 0;
      for (int k = 0; k < K_in; ++k) {
        const int32_t pslot_k = (predw >> (6 * k)) & 31;
        const bool pvalid_k = (predw >> (6 * k + 5)) & 1;
        const bool ppv_k = (predprevw >> (6 * k + 5)) & 1;
        const int32_t u_slot = is_start ? pslot_k : slot;
        const int32_t u_off =
            is_start ? T.nm(lens, cur, pslot_k, b) - 1 : off - 1;
        const bool uv = k == 0 ? (pvalid_k || !is_start) : (is_start && pvalid_k);
        const bool prev_only = is_start && row_in == 0 && !pvalid_k && ppv_k;
        if (!uv && !prev_only) continue;
        const PCol u_col = read_col(T, cur, offs_cur(u_slot) + u_off, b);
        const int32_t horizontal = uv ? value_at(u_col, row_in) : GA_INF;
        const bool take_h = uv && horizontal == here - 1 && !decided;
        const int32_t diag = row_in == 0 ? bd[k] : value_at(u_col, row_in - 1);
        const bool d_ok = matched ? diag == here : diag == here - 1;
        const bool take_d = d_ok && !decided && !take_h;
        if (take_h) move = is_start ? 8 + k : 3;
        if (take_d) move = is_start ? 12 + k : 4;
        if (take_h || take_d) {
          n_slot = u_slot;
          n_off = u_off;
          n_col = u_col;
          decided = true;
        }
        if (take_d) n_row = row_in - 1;
        if (take_h || (take_d && !matched)) n_here = here - 1;
        if (take_d && prev_only) {
          // lands directly in slice q-1 at the pred's end cell: keep its
          // PREVIOUS-band slot and offset
          po_any = true;
          po_slot = (predprevw >> (6 * k)) & 31;
          po_off = po_offs[k];
        }
      }
      const int32_t vert =
          row_in == 0 ? bd[K_in] : value_at(col, row_in - 1);
      if (!decided && vert == here - 1) {
        move = 2;
        n_row = row_in - 1;
        n_here = here - 1;
        decided = true;
      }
      const bool new_fail = !decided;
      const bool moved_down = decided && !spec && n_row < row_in && row_in == 0;
      if (moved_down) {
        int32_t t_slot;
        if (po_any) {
          t_slot = po_slot;
          n_off = po_off;
        } else {
          bool found;
          t_slot = prev_slot_of(T.nm(band, cur, n_slot, b), found);
        }
        s[0] = s[0] - 1;
        n_slot = t_slot;
        n_row = 63;
      }
      s[1] = n_row;
      s[2] = n_slot;
      s[3] = n_off;
      s[4] = n_here;
      s[5] = (spec || (q == 1 && moved_down)) ? 1 : 0;
      s[6] = new_fail ? 1 : 0;
      s[7] = moved_down ? 1 : 0;
      for (int f = 0; f < 5; ++f) s[8 + f] = n_col.w[f];

      word |= (uint32_t)move << (4 * (t % 8));
      if (t % 8 == 7) {
        moves[min(t / 8, T_w - 1) * sB + b] = (int32_t)word;
        word = 0;
      }
      ++t;
    }
  }
  moves[min(t / 8, T_w - 1) * sB + b] = (int32_t)word;
  used_out[b] = t;
  // a lane still inside this window that is not done got stuck -> fail;
  // lanes with sk <= base continue in the next (earlier) window
  fail_out[b] = (s[6] == 1 || (s[5] == 0 && s[0] > base)) ? 1 : 0;
  for (int r = 0; r < 16; ++r) state_out[r * sB + b] = s[r];
}

extern "C" int ga_walk_moves(const int32_t *cols6, const int32_t *band,
                             const int32_t *lens, const int32_t *pred,
                             const int32_t *pprev, const int32_t *mtab,
                             const int32_t *seq_len, const int32_t *seed,
                             const int32_t *win_base,
                             const int32_t *init_state, int32_t *moves,
                             int32_t *fail, int32_t *state_out, int32_t *used,
                             int K, int Cm, int Nm, int B, int K_in,
                             int W_cap, int T_total, int T_w, void *stream) {
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  walk_moves_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cols6, band, lens, pred, pprev, mtab, seq_len, seed, win_base,
      init_state, moves, fail, state_out, used, K, Cm, Nm, B, K_in, W_cap,
      T_total, T_w);
  return (int)cudaGetLastError();
}
