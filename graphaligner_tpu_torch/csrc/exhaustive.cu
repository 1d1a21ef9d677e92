// Exhaustive-mode column DP (kernel K3) for Hopper, sm_90a.
//
// Replaces graphaligner_tpu/ops/pallas/exhaustive.py::make_kernel (the
// pallas_call behind align_exhaustive_pallas): for every read lane and
// every 64-row slice, the P schedule positions in topological order — the
// within-node Myers advance with row -1 closed at min(old_end, sbs + 1),
// the score-space merge over the in-neighbours' last columns at node
// starts, the row-0 free start of source nodes in slice 0 — writing the
// packed slabs (vp_lo, vp_hi, vn_lo, vn_hi, sbs, send), each [S, P, B].
// old_end of slice s is send of slice s - 1, read back from the output.
// It also carries graphaligner_tpu/core/engine.py::_align_batch_device's
// cyclic fixpoint: each slice starts from a node store reset to INF, and on
// a cyclic graph the slice is swept in whole passes (back-edge predecessors
// read the previous pass's store) until none of the lane's outputs change,
// at most max_passes times; a lane still changing is flagged in nonconv.
//
// Design: one thread per lane, looping over slices, passes and positions
// with the column in registers (uint64_t vp/vn, sbs, send, e). The TPU
// kernel's one-hot/VMEM machinery, scalar prefetch and lax.cond predication
// have no counterpart: the schedule arrays are read directly (every lane
// reads the same word, so they stay in L1), the node store is per lane in
// global memory as [N, 6, B] (vp lo/hi, vn lo/hi, sbs, e), written once at
// each node's last position, and every output word is written once,
// coalesced, since the batch is the last axis. The start merge runs over
// the 64 rows on scalars (fully unrolled, so the merged column stays in
// registers): each predecessor's running score from its bits, the advance
// min(p[r] + 1, p[r - 1] + cost), then the vertical closure
// cur[r] = min(base[r], cur[r - 1] + 1) and the repacking.
//
// What bounds it: the card's floor is the bytes — for the longsim graph
// (P = 102,646) x 160 lanes x 11 slices, the 24 * S * P * B = 4.3 GB of
// output, 1.3 ms at 3.35 TB/s, above the 18.4 G int32 operations the
// function needs (a Myers step a position, and a pred advance and merge per
// in-neighbour at node starts), 1.1 ms at the int32 issue rate — but a
// launch there takes about 0.74 s (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py), a share of 0.002: each lane is a serial chain of S * P
// positions (each needs the previous column), and 160 lanes fill 5 warps of
// a 132-SM card. A wavefront over independent positions across the threads
// of a block, and the store in shared memory, are later work.
#include <cuda_runtime.h>

#include "wordops.cuh"

#define EX_INF (1 << 30)
#define EX_FIELDS 6

__global__ void exhaustive_kernel(
    const int32_t *__restrict__ eq,        // [S, 5, 2, B]
    const int32_t *__restrict__ code,      // [P]
    const int32_t *__restrict__ is_start,  // [P]
    const int32_t *__restrict__ is_source, // [P]
    const int32_t *__restrict__ preds,     // [P, K]
    const int32_t *__restrict__ slot,      // [P]
    int32_t *__restrict__ out,             // [6, S, P, B]
    int32_t *__restrict__ store,           // [N, 6, B]
    int32_t *__restrict__ nonconv,         // [B]
    int S, int P, int K, int N, int B, int cyclic, int max_passes) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const size_t fO = (size_t)S * P * sB;  // field stride of out
  const size_t fS = sB;                   // field stride of store
  const size_t nS = EX_FIELDS * sB;       // node stride of store
  int32_t flag = 0;
  for (int s = 0; s < S; ++s) {
    uint64_t eqw[5];
    for (int g = 0; g < 5; ++g)
      eqw[g] = ga_u64(eq[((size_t)(s * 5 + g) * 2) * sB + b],
                      eq[((size_t)(s * 5 + g) * 2 + 1) * sB + b]);
    for (int n = 0; n < N; ++n)
      for (int f = 0; f < EX_FIELDS; ++f)
        store[n * nS + f * fS + b] = f == 4 ? EX_INF : 0;
    const int32_t *old_end = out + 5 * fO + (size_t)(s ? s - 1 : 0) * P * sB + b;
    int32_t *o = out + (size_t)s * P * sB + b;
    bool changed = true;
    int pass = 0;
    while (true) {
      ++pass;
      bool diff = false;
      uint64_t vp = 0, vn = 0;
      int32_t sbs = EX_INF, send = EX_INF, e = 0;
      for (int t = 0; t < P; ++t) {
        const size_t at = (size_t)t * sB;
        const int32_t oe = s ? old_end[at] : 0;
        const uint64_t eqc = eqw[code[t]];
        int32_t r_t;
        if (is_start[t]) {
          int32_t merged[64];
#pragma unroll
          for (int r = 0; r < 64; ++r) merged[r] = EX_INF;
          int32_t r_in = EX_INF;
          for (int k = 0; k < K; ++k) {
            const int pred = preds[t * K + k];
            if (pred < 0) continue;
            const int32_t *p = store + pred * nS + b;
            const uint64_t pvp = ga_u64(p[0], p[fS]);
            const uint64_t pvn = ga_u64(p[2 * fS], p[3 * fS]);
            const int32_t psbs = p[4 * fS];
            const int32_t pe = p[5 * fS];
            r_in = min(r_in, psbs + 1);
            int32_t prev = psbs;
#pragma unroll
            for (int r = 0; r < 64; ++r) {
              const int32_t cur = prev + (int32_t)((pvp >> r) & 1ull) -
                                  (int32_t)((pvn >> r) & 1ull);
              const int32_t mbit = (int32_t)((eqc >> r) & 1ull);
              const int32_t cost = r == 0 ? ((mbit && pe) ? 0 : 1) : 1 - mbit;
              merged[r] = min(merged[r], min(cur + 1, prev + cost));
              prev = cur;
            }
          }
          r_t = min(oe, r_in);
          int32_t row0 = min(merged[0], r_t + 1);
          if (is_source[t] && s == 0)
            row0 = min(row0, r_t + 1 - (int32_t)(eqc & 1ull));
          uint64_t nvp = 0, nvn = 0;
          int32_t prev = r_t, cur = row0;
#pragma unroll
          for (int r = 0; r < 64; ++r) {
            if (r) cur = min(merged[r], prev + 1);
            if (cur > prev) nvp |= 1ull << r;
            if (cur < prev) nvn |= 1ull << r;
            prev = cur;
          }
          vp = nvp;
          vn = nvn;
          send = cur;
        } else {
          r_t = min(oe, sbs + 1);
          uint64_t nvp, nvn;
          int32_t nsend;
          myers_advance(e ? eqc : (eqc & ~1ull), vp, vn, send, r_t - sbs, nvp,
                        nvn, nsend);
          vp = nvp;
          vn = nvn;
          send = nsend;
        }
        sbs = r_t;
        e = r_t == oe;
        const int32_t fields[6] = {
            (int32_t)(uint32_t)vp, (int32_t)(uint32_t)(vp >> 32),
            (int32_t)(uint32_t)vn, (int32_t)(uint32_t)(vn >> 32), sbs, send};
        if (cyclic && pass > 1)
          for (int f = 0; f < 6; ++f) diff |= o[f * fO + at] != fields[f];
        for (int f = 0; f < 6; ++f) o[f * fO + at] = fields[f];
        if (t + 1 == P || slot[t + 1] != slot[t]) {
          int32_t *q = store + slot[t] * nS + b;
          for (int f = 0; f < 5; ++f) q[f * fS] = fields[f];
          q[5 * fS] = e;
        }
      }
      changed = pass == 1 || diff;
      if (!cyclic || !changed || pass >= max_passes) break;
    }
    if (cyclic && changed) flag = 1;
  }
  nonconv[b] = flag;
}

extern "C" int ga_exhaustive(const int32_t *eq, const int32_t *code,
                             const int32_t *is_start, const int32_t *is_source,
                             const int32_t *preds, const int32_t *slot,
                             int32_t *out, int32_t *store, int32_t *nonconv,
                             int S, int P, int K, int N, int B, int cyclic,
                             int max_passes, void *stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  exhaustive_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      eq, code, is_start, is_source, preds, slot, out, store, nonconv, S, P,
      K, N, B, cyclic, max_passes);
  return (int)cudaGetLastError();
}
