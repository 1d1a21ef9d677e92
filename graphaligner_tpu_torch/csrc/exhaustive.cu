// Exhaustive-mode column DP (kernel K3) for Hopper, sm_90a: two routes.
//
// Replaces graphaligner_tpu/ops/pallas/exhaustive.py::make_kernel (the
// pallas_call behind align_exhaustive_pallas): for every read lane and
// every 64-row slice, the P schedule positions in topological order — the
// within-node Myers advance with row -1 closed at min(old_end, sbs + 1),
// the score-space merge over the in-neighbours' last columns at node
// starts, the row-0 free start of source nodes in slice 0 — writing the
// packed slabs (vp_lo, vp_hi, vn_lo, vn_hi, sbs, send), each [S, P, B].
// old_end of slice s at position t is send of slice s - 1 at t.
//
// Route 1, exhaustive_wavefront_kernel (acyclic graphs). Slice s at
// position t needs only its own running column and send[s - 1][t], so the
// slices run as a diagonal wavefront: one warp per slice, 8 lanes across
// the warp (so every slab store is a whole 32-byte sector, batch last), each
// carried by 4 threads that split a node start's 64-row merge between them,
// positions in chunks of T. In block round r, slice-warp w computes chunk
// r - w and hands that chunk's send row to warp w + 1 through a
// double-buffered ring in shared memory; one block barrier a round. A
// lane's dependent steps drop from S * P to about P + (W - 1) * T per group
// of W slices, and old_end comes from shared memory, never from the slabs
// being written. The schedule (code, start, source flags, node slot,
// in-neighbours) is the same for every lane: it is staged one round ahead
// with cp.async into a ring of W + 1 chunks, those the warps work on and the
// next. With more slices than warps, the slices run in groups of W; the
// first slice of group g + 1 reads its old_end from the last send slab of
// group g (complete by then), staged the same way. Each slice-warp keeps its
// own node store ([W, N, 6, B] scratch, reused by the groups) and does not
// reset it: on an acyclic graph every predecessor of a node start is
// scheduled, and so written, earlier in the same slice. A node's end is
// stored by one thread of each lane and read at a later node start by all
// four (and by the warp's lanes past B), so the warp syncs after each store.
//
// Route 2, exhaustive_serial_kernel (cyclic graphs): graphaligner_tpu/
// core/engine.py::_align_batch_device's fixpoint. One thread per lane loops
// over slices, whole-slice passes and positions; each slice starts from a
// node store reset to INF, and the slice is swept in passes (back-edge
// predecessors read the previous pass's store) until none of the lane's
// outputs change, at most max_passes times; a lane still changing is
// flagged in nonconv.
//
// Both keep the column in registers (uint64_t vp/vn, sbs, send, e) and
// merge a node start in score space over 64 unrolled rows: each
// predecessor's running score from its bits, the advance
// min(p[r] + 1, p[r - 1] + cost), then the vertical closure
// cur[r] = min(base[r], cur[r - 1] + 1) and the repacking.
//
// What bounds it: the card's floor is the bytes — for the longsim graph
// (P = 102,646) x 160 lanes x 11 slices, the 24 * S * P * B = 4.3 GB of
// output, 1.3 ms at 3.35 TB/s, above the 18.4 G int32 operations the
// function needs, 1.1 ms at the int32 issue rate. The serial route took
// about 0.74 s there (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): 1.13 M
// dependent positions a lane, each waiting on a DRAM load of old_end. The
// wavefront cuts the chain to about 103 k positions with no DRAM load on
// it, and the wavefront takes about 52 ms there: what bounds it is still
// each slice-warp's chain of dependent latencies, about 1,000 cycles a
// position, not the SM's issue rate — a block of 4 slice-warps runs a round
// in nearly the time a block of 11 does. The merge split over the threads of
// a lane, and the Eq word picked in registers, shorten that chain.
#include <cuda_runtime.h>

#include "wordops.cuh"

#define EX_INF (1 << 30)
#define EX_FIELDS 6
#define EX_MAX_WARPS 16
#define EX_WAVE_G 4  // threads a lane in the wavefront: 32 / 4 = 8 lanes a warp

__device__ __forceinline__ void cp_async4(void *smem, const void *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One schedule position: the node-start merge or the within-node advance.
// Returns the new column through vp/vn/send; sbs and e follow from r_t.
// G threads share a lane (the threads lane + L * sub, L = 32 / G, sub < G;
// the schedule, and so the branch, is the same across the warp): each
// merges rows [sub * R, sub * R + R) of a node start, R = 64 / G, closes
// them vertically from the carry of the rows below — the closure
// cur[r] = min(m[r], cur[r - 1] + 1) is cur[r] = min_j (m[j] + r - j), so
// the carry into row group sub is min_{j < sub} (end_j + R * (sub - 1 - j))
// over the groups' local closures end_j — and the groups' bits are OR-ed
// together; every thread of the lane ends with the whole column. The
// within-node advance runs on all G threads alike.
template <int G>
__device__ __forceinline__ int32_t ex_step(
    const int32_t *store, size_t fS, size_t nS, uint64_t eqc, bool start,
    bool source0, const int32_t *preds, int K, int32_t oe, uint64_t &vp,
    uint64_t &vn, int32_t sbs, int32_t &send, int32_t e, int lane, int sub) {
  constexpr int R = 64 / G, L = 32 / G;
  int32_t r_t;
  if (start) {
    const int r0 = sub * R;
    const uint64_t below = (1ull << r0) - 1ull;  // r0 < 64
    const uint64_t eq_s = eqc >> r0;
    int32_t m[R];
#pragma unroll
    for (int i = 0; i < R; ++i) m[i] = EX_INF;
    int32_t r_in = EX_INF;
    for (int k = 0; k < K; ++k) {
      const int pred = preds[k];
      if (pred < 0) continue;
      const int32_t *p = store + pred * nS;
      const uint64_t pvp = ga_u64(p[0], p[fS]);
      const uint64_t pvn = ga_u64(p[2 * fS], p[3 * fS]);
      const int32_t psbs = p[4 * fS];
      const int32_t pe = p[5 * fS];
      r_in = min(r_in, psbs + 1);
      // the predecessor's score at row r0 - 1 (psbs at row -1)
      int32_t prev = psbs + __popcll(pvp & below) - __popcll(pvn & below);
      const uint64_t vp_s = pvp >> r0, vn_s = pvn >> r0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int32_t cur = prev + (int32_t)((vp_s >> i) & 1ull) -
                            (int32_t)((vn_s >> i) & 1ull);
        const int32_t mbit = (int32_t)((eq_s >> i) & 1ull);
        const int32_t cost =
            (i == 0 && r0 == 0) ? ((mbit && pe) ? 0 : 1) : 1 - mbit;
        m[i] = min(m[i], min(cur + 1, prev + cost));
        prev = cur;
      }
    }
    r_t = min(oe, r_in);
    if (r0 == 0) {
      m[0] = min(m[0], r_t + 1);
      if (source0) m[0] = min(m[0], r_t + 1 - (int32_t)(eqc & 1ull));
    }
#pragma unroll
    for (int i = 1; i < R; ++i) m[i] = min(m[i], m[i - 1] + 1);
    int32_t carry = r_t;  // the score of row r0 - 1
    if constexpr (G > 1) {
      int32_t ends[G];
#pragma unroll
      for (int j = 0; j < G; ++j)
        ends[j] = __shfl_sync(0xFFFFFFFFu, m[R - 1], lane + L * j);
      if (sub > 0) {
        carry = ends[sub - 1];
#pragma unroll
        for (int j = 0; j < G - 1; ++j)
          if (j < sub - 1) carry = min(carry, ends[j] + R * (sub - 1 - j));
#pragma unroll
        for (int i = 0; i < R; ++i) m[i] = min(m[i], carry + i + 1);
      }
    }
    uint64_t nvp = 0, nvn = 0;
    int32_t prev = carry;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (m[i] > prev) nvp |= 1ull << i;
      if (m[i] < prev) nvn |= 1ull << i;
      prev = m[i];
    }
    nvp <<= r0;
    nvn <<= r0;
    send = m[R - 1];
    if constexpr (G > 1) {
      uint64_t all_vp = 0, all_vn = 0;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        all_vp |= __shfl_sync(0xFFFFFFFFu, nvp, lane + L * j);
        all_vn |= __shfl_sync(0xFFFFFFFFu, nvn, lane + L * j);
      }
      nvp = all_vp;
      nvn = all_vn;
      send = __shfl_sync(0xFFFFFFFFu, send, lane + L * (G - 1));
    }
    vp = nvp;
    vn = nvn;
  } else {
    r_t = min(oe, sbs + 1);
    uint64_t nvp, nvn;
    int32_t nsend;
    myers_advance(e ? eqc : (eqc & ~1ull), vp, vn, send, r_t - sbs, nvp, nvn,
                  nsend);
    vp = nvp;
    vn = nvn;
    send = nsend;
  }
  return r_t;
}

// ---------------------------------------------------------------- route 1
// Shared memory: ring [W][2][T][L] of old_end rows, then W + 1 staged
// schedule chunks of CH = 4T + 1 + T*K words each: code [T], is_start [T],
// is_source [T], node_slot [T + 1] (the next chunk's first slot closes the
// last node), in-neighbours [T*K].
__device__ __forceinline__ void ex_stage(
    int32_t *ch, int c, int T, int P, int K, const int32_t *code,
    const int32_t *is_start, const int32_t *is_source, const int32_t *preds,
    const int32_t *slot) {
  const int t0 = c * T;
  const int n = min(T, P - t0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    cp_async4(ch + i, code + t0 + i);
    cp_async4(ch + T + i, is_start + t0 + i);
    cp_async4(ch + 2 * T + i, is_source + t0 + i);
    cp_async4(ch + 3 * T + i, slot + t0 + i);
  }
  if (threadIdx.x == 0 && t0 + T < P) cp_async4(ch + 4 * T, slot + t0 + T);
  int32_t *pr = ch + 4 * T + 1;
  for (int i = threadIdx.x; i < n * K; i += blockDim.x)
    cp_async4(pr + i, preds + (size_t)t0 * K + i);
}

// old_end rows of chunk c for the group's first slice: the send slab of
// slice s_prev, lanes [b0, b0 + L).
__device__ __forceinline__ void ex_stage_old_end(int32_t *dst,
                                                 const int32_t *send_slab,
                                                 int c, int T, int P, int L,
                                                 int b0, int B) {
  const size_t sB = (size_t)B;
  for (int i = threadIdx.x; i < T * L; i += blockDim.x) {
    const int t = c * T + i / L, bb = b0 + i % L;
    if (t < P && bb < B) cp_async4(dst + i, send_slab + (size_t)t * sB + bb);
  }
}

__global__ void __launch_bounds__(EX_MAX_WARPS * 32)
    exhaustive_wavefront_kernel(
        const int32_t *__restrict__ eq,        // [S, 5, 2, B]
        const int32_t *__restrict__ code,      // [P]
        const int32_t *__restrict__ is_start,  // [P]
        const int32_t *__restrict__ is_source, // [P]
        const int32_t *__restrict__ preds,     // [P, K]
        const int32_t *__restrict__ slot,      // [P]
        int32_t *__restrict__ out,             // [6, S, P, B]
        int32_t *__restrict__ store,           // [W, N, 6, B]
        int S, int P, int K, int N, int B, int T, int W) {
  constexpr int G = EX_WAVE_G, L = 32 / G;  // threads a lane, lanes a warp
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = (threadIdx.x & 31) % L, sub = (threadIdx.x & 31) / L;
  const int b0 = blockIdx.x * L;
  const int b = b0 + lane;
  // a lane past B computes on lane B - 1's inputs and stores nothing, so
  // that every thread of the warp takes part in the merge's shuffles
  const int bc = min(b, B - 1);
  const bool writer = sub == 0 && b < B;
  const size_t sB = (size_t)B;
  const size_t fO = (size_t)S * P * sB;  // field stride of out
  const size_t fS = sB;                   // field stride of store
  const size_t nS = EX_FIELDS * sB;       // node stride of store
  const int CH = 4 * T + 1 + T * K;
  const int nchunks = (P + T - 1) / T;
  int32_t *ring = smem;                        // [W][2][T][L]
  int32_t *sched = smem + (size_t)W * 2 * T * L;  // [W + 1][CH]
  int32_t *st = store + (size_t)warp * N * nS + bc;

  for (int g0 = 0; g0 < S; g0 += W) {
    const int Wg = min(W, S - g0);
    const int s = g0 + warp;
    const bool on = warp < Wg;
    uint64_t eqw[5] = {0, 0, 0, 0, 0};
    if (on) {
#pragma unroll
      for (int g = 0; g < 5; ++g)
        eqw[g] = ga_u64(eq[((size_t)(s * 5 + g) * 2) * sB + bc],
                        eq[((size_t)(s * 5 + g) * 2 + 1) * sB + bc]);
    }
    uint64_t vp = 0, vn = 0;
    int32_t sbs = EX_INF, send = EX_INF, e = 0;
    const int32_t *prev_send =
        out + 5 * fO + (size_t)(g0 > 0 ? g0 - 1 : 0) * P * sB;
    // the previous group is done with the staging rings (and its send
    // slabs are visible to the block)
    __syncthreads();
    ex_stage(sched, 0, T, P, K, code, is_start, is_source, preds, slot);
    if (g0 > 0)
      ex_stage_old_end(ring + T * L, prev_send, 0, T, P, L, b0, B);
    cp_async_wait_all();
    __syncthreads();
    const int rounds = nchunks + Wg - 1;
    for (int r = 0; r < rounds; ++r) {
      if (r + 1 < nchunks) {
        ex_stage(sched + ((r + 1) % (W + 1)) * CH, r + 1, T, P, K, code,
                 is_start, is_source, preds, slot);
        if (g0 > 0)
          ex_stage_old_end(ring + (r & 1) * T * L, prev_send, r + 1, T, P,
                           L, b0, B);
      }
      const int c = r - warp;
      if (on && c >= 0 && c < nchunks) {
        const int32_t *ch = sched + (c % (W + 1)) * CH;
        // written in round r - 1: buffer (r - 1) & 1
        const int32_t *oe_in = ring + (warp * 2 + ((r + 1) & 1)) * T * L + lane;
        int32_t *oe_out = warp + 1 < Wg && sub == 0
                              ? ring + ((warp + 1) * 2 + (r & 1)) * T * L + lane
                              : nullptr;
        const int t0 = c * T, tn = min(T, P - t0);
        int32_t *o = out + (size_t)s * P * sB + b;
        for (int i = 0; i < tn; ++i) {
          const int t = t0 + i;
          const int32_t oe = s ? oe_in[i * L] : 0;
          const uint64_t eqc = ga_pick5(eqw, ch[i]);
          const int32_t r_t = ex_step<G>(
              st, fS, nS, eqc, ch[T + i] != 0, ch[2 * T + i] != 0 && s == 0,
              ch + 4 * T + 1 + i * K, K, oe, vp, vn, sbs, send, e, lane, sub);
          sbs = r_t;
          e = r_t == oe;
          if (oe_out) oe_out[i * L] = send;
          if (writer) {
            const size_t at = (size_t)t * sB;
            o[at] = (int32_t)(uint32_t)vp;
            o[fO + at] = (int32_t)(uint32_t)(vp >> 32);
            o[2 * fO + at] = (int32_t)(uint32_t)vn;
            o[3 * fO + at] = (int32_t)(uint32_t)(vn >> 32);
            o[4 * fO + at] = sbs;
            o[5 * fO + at] = send;
          }
          // a node end (the same for the whole warp): its store, read at a
          // later start by every thread of the lane
          if (t + 1 == P || ch[3 * T + i + 1] != ch[3 * T + i]) {
            if (writer) {
              int32_t *q = st + ch[3 * T + i] * nS;
              q[0] = (int32_t)(uint32_t)vp;
              q[fS] = (int32_t)(uint32_t)(vp >> 32);
              q[2 * fS] = (int32_t)(uint32_t)vn;
              q[3 * fS] = (int32_t)(uint32_t)(vn >> 32);
              q[4 * fS] = sbs;
              q[5 * fS] = e;
            }
            __syncwarp();
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }
  }
}

// smem: the bytes of the rings above, 4 * (W*2*T*L + (W + 1) * CH),
// computed by the wrapper (ops/exhaustive.py::wave_shape).
extern "C" int ga_exhaustive_wavefront(
    const int32_t *eq, const int32_t *code, const int32_t *is_start,
    const int32_t *is_source, const int32_t *preds, const int32_t *slot,
    int32_t *out, int32_t *store, int S, int P, int K, int N, int B, int T,
    int W, int smem, void *stream) {
  if (W < 1 || W > EX_MAX_WARPS || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      exhaustive_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int L = 32 / EX_WAVE_G;
  exhaustive_wavefront_kernel<<<(B + L - 1) / L, W * 32, smem,
                                (cudaStream_t)stream>>>(
      eq, code, is_start, is_source, preds, slot, out, store, S, P, K, N, B,
      T, W);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- route 2
__global__ void exhaustive_serial_kernel(
    const int32_t *__restrict__ eq,        // [S, 5, 2, B]
    const int32_t *__restrict__ code,      // [P]
    const int32_t *__restrict__ is_start,  // [P]
    const int32_t *__restrict__ is_source, // [P]
    const int32_t *__restrict__ preds,     // [P, K]
    const int32_t *__restrict__ slot,      // [P]
    int32_t *__restrict__ out,             // [6, S, P, B]
    int32_t *__restrict__ store,           // [N, 6, B]
    int32_t *__restrict__ nonconv,         // [B]
    int S, int P, int K, int N, int B, int max_passes) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const size_t fO = (size_t)S * P * sB;  // field stride of out
  const size_t fS = sB;                   // field stride of store
  const size_t nS = EX_FIELDS * sB;       // node stride of store
  int32_t *st = store + b;
  int32_t flag = 0;
  for (int s = 0; s < S; ++s) {
    uint64_t eqw[5];
#pragma unroll
    for (int g = 0; g < 5; ++g)
      eqw[g] = ga_u64(eq[((size_t)(s * 5 + g) * 2) * sB + b],
                      eq[((size_t)(s * 5 + g) * 2 + 1) * sB + b]);
    for (int n = 0; n < N; ++n)
      for (int f = 0; f < EX_FIELDS; ++f)
        st[n * nS + f * fS] = f == 4 ? EX_INF : 0;
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
        const int32_t r_t = ex_step<1>(
            st, fS, nS, ga_pick5(eqw, code[t]), is_start[t] != 0,
            is_source[t] != 0 && s == 0, preds + (size_t)t * K, K, oe, vp, vn,
            sbs, send, e, 0, 0);
        sbs = r_t;
        e = r_t == oe;
        const int32_t fields[6] = {
            (int32_t)(uint32_t)vp, (int32_t)(uint32_t)(vp >> 32),
            (int32_t)(uint32_t)vn, (int32_t)(uint32_t)(vn >> 32), sbs, send};
        if (pass > 1)
          for (int f = 0; f < 6; ++f) diff |= o[f * fO + at] != fields[f];
        for (int f = 0; f < 6; ++f) o[f * fO + at] = fields[f];
        if (t + 1 == P || slot[t + 1] != slot[t]) {
          int32_t *q = st + slot[t] * nS;
          for (int f = 0; f < 5; ++f) q[f * fS] = fields[f];
          q[5 * fS] = e;
        }
      }
      changed = pass == 1 || diff;
      if (!changed || pass >= max_passes) break;
    }
    if (changed) flag = 1;
  }
  nonconv[b] = flag;
}

extern "C" int ga_exhaustive_serial(const int32_t *eq, const int32_t *code,
                                    const int32_t *is_start,
                                    const int32_t *is_source,
                                    const int32_t *preds, const int32_t *slot,
                                    int32_t *out, int32_t *store,
                                    int32_t *nonconv, int S, int P, int K,
                                    int N, int B, int max_passes,
                                    void *stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  exhaustive_serial_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      eq, code, is_start, is_source, preds, slot, out, store, nonconv, S, P,
      K, N, B, max_passes);
  return (int)cudaGetLastError();
}
