// Bit-parallel word operations on native 64-bit words (device side).
//
// Device counterpart of graphaligner_tpu/ops/wordops.py: a 64-row DP
// column is (vp, vn) as uint64_t plus its row -1 score sbs and its row 63
// score send (reference WordSlice.h). The Myers advance, the merge and the
// row score run on whole 64-bit words; differenceMasks keeps the
// reference's byte arithmetic on the two 32-bit halves, with the high half
// continuing from the low half's totals, exactly as the JAX version does,
// so both round a byte overflow the same way.
#pragma once
#include <cstdint>

#define GA_INF (1 << 20)
#define GA_EMPTY 0x7FFFFFFF

struct Col {
  uint64_t vp, vn;
  int32_t sbs, send, e;
};

__device__ __forceinline__ uint64_t ga_u64(int32_t lo, int32_t hi) {
  return (uint64_t)(uint32_t)lo | ((uint64_t)(uint32_t)hi << 32);
}

// w[code] for a code in [0, 5), 0 for any other, by selects: a dynamic
// index would put w in local memory, a load on every cell's chain.
__device__ __forceinline__ uint64_t ga_pick5(const uint64_t (&w)[5],
                                             int code) {
  uint64_t r = 0;
#pragma unroll
  for (int g = 0; g < 5; ++g) r = code == g ? w[g] : r;
  return r;
}

// One column advance (reference getNextSlice); hin = new sbs - pred sbs.
__device__ __forceinline__ void myers_advance(uint64_t eq, uint64_t vp,
                                              uint64_t vn, int32_t send,
                                              int32_t hin, uint64_t &nvp,
                                              uint64_t &nvn, int32_t &nsend) {
  if (hin < 0) eq |= 1ull;
  const uint64_t xv = eq | vn;
  const uint64_t s = (eq & vp) + vp;
  const uint64_t xh = (s ^ vp) | eq;
  uint64_t ph = vn | ~(xh | vp);
  uint64_t mh = vp & xh;
  nsend = send + (int32_t)(ph >> 63) - (int32_t)(mh >> 63);
  ph <<= 1;
  mh <<= 1;
  if (hin > 0) ph |= 1ull;
  if (hin < 0) mh |= 1ull;
  nvp = mh | ~(xv | ph);
  nvn = ph & xv;
}

__device__ __forceinline__ uint32_t chunk_popcounts(uint32_t x) {
  x = x - ((x >> 1) & 0x55555555u);
  x = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);
  return (x + (x >> 4)) & 0x0F0F0F0Fu;
}

__device__ __forceinline__ uint32_t byte_prefix_sums(uint32_t value,
                                                     uint32_t addition) {
  value <<= 8;
  value += addition;
  return value * 0x01010101u;
}

__device__ __forceinline__ uint32_t byte_vpvn_sum(uint32_t p_vp,
                                                  uint32_t p_vn) {
  return (0x80808080u + p_vp - p_vn) ^ 0x80808080u;
}

__device__ __forceinline__ uint32_t diff_combine(uint32_t sum_left,
                                                 uint32_t sum_right) {
  const uint32_t SIGN = 0x80808080u, LSB = 0x01010101u;
  const uint32_t smear = ((sum_right & SIGN) >> 7) * 0x7Fu;
  const uint32_t deductions = ~smear & sum_right & ~SIGN;
  const uint32_t additions = (smear & ~sum_right) + (smear & LSB);
  uint32_t d = sum_left;
  uint32_t signs = d & SIGN;
  d &= ~SIGN;
  d += additions;
  d ^= signs;
  signs = d & SIGN;
  d |= SIGN;
  d -= deductions;
  signs ^= SIGN & ~d;
  d &= ~SIGN;
  return d | signs;
}

// The 8-bit refinement loop of differenceMasks (WordSlice.h:577-609).
__device__ __forceinline__ void dm_half(uint32_t d, uint32_t l_vp,
                                        uint32_t l_vn, uint32_t r_vp,
                                        uint32_t r_vn, uint32_t &ls,
                                        uint32_t &rs) {
  const uint32_t SIGN = 0x80808080u, LSB = 0x01010101u;
  ls = 0;
  rs = 0;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    uint32_t signs = d & SIGN;
    d &= ~SIGN;
    d = d + (l_vp & LSB) + (r_vn & LSB);
    d ^= signs;
    signs = d & SIGN;
    d |= SIGN;
    d = d - (l_vn & LSB) - (r_vp & LSB);
    signs ^= SIGN & ~d;
    d &= ~SIGN;
    d |= signs;
    l_vp >>= 1;
    l_vn >>= 1;
    r_vp >>= 1;
    r_vn >>= 1;
    const uint32_t negative = d & SIGN;
    ls |= negative >> (7 - bit);
    const uint32_t not_zero = ((d | SIGN) - LSB) & SIGN;
    rs |= (not_zero & ~negative) >> (7 - bit);
  }
}

// Per-row comparison masks of two columns, right.sbs - left.sbs =
// score_diff >= 0 (reference differenceMasks, WordSlice.h:512-615).
__device__ __forceinline__ void difference_masks(uint64_t lvp, uint64_t lvn,
                                                 uint64_t rvp, uint64_t rvn,
                                                 uint32_t score_diff,
                                                 uint64_t &ls, uint64_t &rs) {
  const uint64_t vp_common = ~(lvp & rvp);
  const uint64_t vn_common = ~(lvn & rvn);
  lvp &= vp_common;
  lvn &= vn_common;
  rvp &= vp_common;
  rvn &= vn_common;
  const bool all_left =
      score_diff > (uint32_t)(__popcll(rvn) + __popcll(lvp));
  const uint32_t lvp_lo = (uint32_t)lvp, lvp_hi = (uint32_t)(lvp >> 32);
  const uint32_t lvn_lo = (uint32_t)lvn, lvn_hi = (uint32_t)(lvn >> 32);
  const uint32_t rvp_lo = (uint32_t)rvp, rvp_hi = (uint32_t)(rvp >> 32);
  const uint32_t rvn_lo = (uint32_t)rvn, rvn_hi = (uint32_t)(rvn >> 32);
  const uint32_t sd = score_diff;
  const uint32_t sum_left_lo =
      byte_vpvn_sum(byte_prefix_sums(chunk_popcounts(lvp_lo), 0u),
                    byte_prefix_sums(chunk_popcounts(lvn_lo), 0u));
  const uint32_t sum_right_lo =
      byte_vpvn_sum(byte_prefix_sums(chunk_popcounts(rvp_lo), sd),
                    byte_prefix_sums(chunk_popcounts(rvn_lo), 0u));
  const uint32_t sum_left_hi = byte_vpvn_sum(
      byte_prefix_sums(chunk_popcounts(lvp_hi), (uint32_t)__popc(lvp_lo)),
      byte_prefix_sums(chunk_popcounts(lvn_hi), (uint32_t)__popc(lvn_lo)));
  const uint32_t sum_right_hi = byte_vpvn_sum(
      byte_prefix_sums(chunk_popcounts(rvp_hi), sd + (uint32_t)__popc(rvp_lo)),
      byte_prefix_sums(chunk_popcounts(rvn_hi), (uint32_t)__popc(rvn_lo)));
  uint32_t ls_lo, rs_lo, ls_hi, rs_hi;
  dm_half(diff_combine(sum_left_lo, sum_right_lo), lvp_lo, lvn_lo, rvp_lo,
          rvn_lo, ls_lo, rs_lo);
  dm_half(diff_combine(sum_left_hi, sum_right_hi), lvp_hi, lvn_hi, rvp_hi,
          rvn_hi, ls_hi, rs_hi);
  ls = (uint64_t)ls_lo | ((uint64_t)ls_hi << 32);
  rs = (uint64_t)rs_lo | ((uint64_t)rs_hi << 32);
  // special cases (WordSlice.h:534-541)
  if (rvn == ~0ull && lvp == ~0ull) {
    if (score_diff == 128) {
      ls = ~0ull ^ (1ull << 63);
      rs = 0;
    } else if (score_diff == 0) {
      ls = 0;
      rs = ~0ull;
    }
  }
  if (all_left) {
    ls = ~0ull;
    rs = 0;
  }
}

// Elementwise min of two columns (reference mergeTwoSlices,
// WordSlice.h:361-421).
__device__ __forceinline__ Col merge_slices(const Col &a, const Col &b) {
  const bool swap = a.sbs > b.sbs;
  const Col &l = swap ? b : a;
  const Col &r = swap ? a : b;
  uint64_t ls, rs;
  difference_masks(l.vp, l.vn, r.vp, r.vn, (uint32_t)(r.sbs - l.sbs), ls,
                   rs);
  const uint64_t mask = (rs | ((ls | rs) - (rs << 1))) & ~ls;
  const uint64_t left_red = ls & (rs << 1);
  uint64_t right_red = rs & (ls << 1);
  if ((rs & 1ull) && l.sbs < r.sbs) right_red |= 1ull;
  const uint64_t l_vn = l.vn & ~left_red;
  const uint64_t r_vn = r.vn & ~right_red;
  Col out;
  out.vn = (l_vn & ~mask) | (r_vn & mask);
  out.vp = (l.vp & ~mask) | (r.vp & mask);
  out.sbs = min(l.sbs, r.sbs);
  out.send = min(l.send, r.send);
  out.e = l.sbs < r.sbs ? l.e : (r.sbs < l.sbs ? r.e : (l.e | r.e));
  return out;
}

// Score at row r (clipped to [0, 63]) of a packed column: masked popcount.
__device__ __forceinline__ int32_t col_value(uint64_t vp, uint64_t vn,
                                             int32_t sbs, int32_t r) {
  r = r < 0 ? 0 : (r > 63 ? 63 : r);
  const uint64_t m = r >= 63 ? ~0ull : ((1ull << (r + 1)) - 1ull);
  return sbs + __popcll(vp & m) - __popcll(vn & m);
}
