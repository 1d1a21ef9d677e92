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
// Route 2, exhaustive_cyclic_kernel (cyclic graphs): graphaligner_tpu/
// core/engine.py::_align_batch_device's fixpoint. Each slice starts from a
// node store reset to INF and is swept in passes (a back-edge in-neighbour
// reads the store as the previous pass left it) until no output of a lane
// changes, at most max_passes times; a lane still changing is flagged in
// nonconv. The wavefront's lane layout: 8 lanes a warp, 4 threads a lane
// splitting a node start's merge, up to 4 independent warps a block. The
// kernel works node by node (each node's positions are contiguous in the
// schedule; the wrapper numbers the nodes by their schedule rank). A
// node's outputs follow from its start column, and the start column only
// from old_end, the Eq word and the in-neighbours' stored end columns. So
// in pass k >= 2 a node can differ from pass k - 1 only if an in-neighbour's
// end column, as read there, changed: a forward one (rank below) earlier in
// this pass, a back one (rank at or above) in pass k - 1. Each warp keeps
// two generations of need bits per node in shared memory: pass 1 takes
// every node and marks for pass 2 those with a back in-neighbour (whose
// store left the reset value); in later passes a node whose end column
// changed for any lane of the warp marks its out-neighbours, after it in
// this pass, at or before it in the next. Every other node is skipped: its
// slab entries and its store already hold the previous pass's values. A
// lane's pass changed iff a recomputed node's start column differs from
// the slab's, one compare a node. Pass 1 reads only in-neighbours ranked
// below the node (the others hold the reset store, which adds nothing to a
// merge), so the store needs no reset. The node tables (first position and
// source flag, in-neighbours) are staged once into shared memory where
// they fit, else read from device memory; the per-position code and the
// warp's old_end row travel in chunks of 32 positions through a ring of two
// buffers, staged with cp.async a chunk ahead and waited for only where a
// node or a chunk begins (the next position's inputs are read a position
// early). The node store [N][6][8] sits in shared memory where it fits
// beside the tables, else in device memory [N, 6, B]. Each warp adds its
// passes, recomputed nodes and positions to a per-slice pass log.
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
// function needs, 1.1 ms at the int32 issue rate. A serial kernel (one
// thread a lane) took about 0.74 s there (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py): 1.13 M dependent positions a lane, each waiting on a
// DRAM load of old_end. The
// wavefront cuts the chain to about 103 k positions with no DRAM load on
// it, and the wavefront takes about 52 ms there: what bounds it is still
// each slice-warp's chain of dependent latencies, about 1,000 cycles a
// position, not the SM's issue rate — a block of 4 slice-warps runs a round
// in nearly the time a block of 11 does. The merge split over the threads of
// a lane, and the Eq word picked in registers, shorten that chain. The
// cyclic route is bound the same way, by each warp's chain over S slices
// and its passes; recomputing only the nodes whose inputs changed cuts the
// passes' share of that chain (to 3.2 to 3.6 whole passes of 7 to 13 on
// sim/cyclic.gfa and on the longsim graph closed into a circle), and the
// staged tables, the two-store column and the node start outside the
// position loop cut a position to about 250-280 ns (NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py --baseline: 5.5x and 11.9x the serial
// kernel it replaced).
#include <cuda_runtime.h>

#include "wordops.cuh"

#define EX_INF (1 << 30)
#define EX_FIELDS 6
#define EX_MAX_WARPS 16
#define EX_WAVE_G 4  // threads a lane in both routes: 32 / 4 = 8 lanes a warp
#define EX_CYC_CHUNK 32  // positions a staged chunk of the cyclic route
#define EX_CYC_MAX_WARPS 4  // warps a block of the cyclic route

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
// within-node advance runs on all G threads alike. In-neighbours at or above
// lim are skipped.
template <int G>
__device__ __forceinline__ int32_t ex_step(
    const int32_t *store, size_t fS, size_t nS, uint64_t eqc, bool start,
    bool source0, const int32_t *preds, int K, int lim, int32_t oe,
    uint64_t &vp, uint64_t &vn, int32_t sbs, int32_t &send, int32_t e,
    int lane, int sub) {
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
      if (pred < 0 || pred >= lim) continue;
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
              ch + 4 * T + 1 + i * K, K, N, oe, vp, vn, sbs, send, e, lane,
              sub);
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
// Shared memory, in int32 words: the node tables when they fit (nodes
// [N + 1], npred [N * K]), then for each warp its need bits [2][NW]
// (NW = ceil(N / 32)), its ring of two staged chunks (old_end [2][T][L],
// code [2][T]) and, when it fits, its node store [N][6][L]. The sizes are
// computed by the wrapper (ops/exhaustive.py::cyclic_shape).
__device__ __forceinline__ void cyc_stage(int32_t *ring_oe, int32_t *ring_code,
                                          int c, int P, int s,
                                          const int32_t *code,
                                          const int32_t *prev_send, int b0,
                                          int B, int tid) {
  constexpr int L = 32 / EX_WAVE_G, T = EX_CYC_CHUNK;
  const int t0 = c * T, n = min(T, P - t0);
  int32_t *dc = ring_code + (c & 1) * T;
  for (int i = tid; i < n; i += 32) cp_async4(dc + i, code + t0 + i);
  if (s > 0) {
    int32_t *doe = ring_oe + (c & 1) * T * L;
    for (int i = tid; i < n * L; i += 32)
      cp_async4(doe + i,
                prev_send + (size_t)(t0 + i / L) * B + min(b0 + i % L, B - 1));
  }
}

// The warp's ring of two staged chunks (warp-uniform): the chunk each
// buffer holds and whether its copy is known to have landed. Fields, not
// arrays, so that it stays in registers.
struct CycRing {
  int tag0 = -1, tag1 = -1;
  bool done0 = true, done1 = true;
  __device__ int tag(int c) const { return (c & 1) ? tag1 : tag0; }
  __device__ bool done(int c) const { return (c & 1) ? done1 : done0; }
  __device__ void issued(int c) {
    if (c & 1) {
      tag1 = c;
      done1 = false;
    } else {
      tag0 = c;
      done0 = false;
    }
  }
  // every copy of the warp landed and visible to all its threads
  __device__ void wait() {
    cp_async_wait_all();
    __syncwarp();
    done0 = done1 = true;
  }
};

__global__ void __launch_bounds__(EX_CYC_MAX_WARPS * 32)
    exhaustive_cyclic_kernel(
        const int32_t *__restrict__ eq,        // [S, 5, 2, B]
        const int32_t *__restrict__ code,      // [P]
        const int32_t *__restrict__ nodes,     // [N + 1]
        const int32_t *__restrict__ npred,     // [N, K]
        const int32_t *__restrict__ succ_ptr,  // [N + 1]
        const int32_t *__restrict__ succ,      // [E]
        int32_t *__restrict__ out,             // [6, S, P, B]
        int32_t *__restrict__ gstore,          // [N, 6, B] or unused
        int32_t *__restrict__ nonconv,         // [B]
        int32_t *__restrict__ plog,            // [S, max_passes, 3]
        int S, int P, int K, int N, int B, int max_passes, int W,
        int table_smem, int store_smem) {
  constexpr int G = EX_WAVE_G, L = 32 / G, T = EX_CYC_CHUNK;
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, tid = threadIdx.x & 31;
  const int lane = tid % L, sub = tid / L;
  const int32_t *tnodes = nodes, *tpred = npred;
  int32_t *base = smem;
  if (table_smem) {
    for (int i = threadIdx.x; i <= N; i += blockDim.x) base[i] = nodes[i];
    for (int i = threadIdx.x; i < N * K; i += blockDim.x)
      base[N + 1 + i] = npred[i];
    tnodes = base;
    tpred = base + N + 1;
    base += N + 1 + N * K;
  }
  __syncthreads();  // the block's only barrier: the warps run apart below
  const int NW = (N + 31) / 32;
  const int per_warp =
      2 * NW + 2 * T * (L + 1) + (store_smem ? N * EX_FIELDS * L : 0);
  int32_t *wbase = base + warp * per_warp;
  uint32_t *need = (uint32_t *)wbase;  // [2][NW]
  int32_t *ring_oe = wbase + 2 * NW;    // [2][T][L]
  int32_t *ring_code = ring_oe + 2 * T * L;  // [2][T]
  const int b0 = (blockIdx.x * W + warp) * L;
  if (b0 >= B) return;
  const int b = b0 + lane, bc = min(b, B - 1);
  const bool valid = b < B;
  const size_t sB = (size_t)B;
  const size_t fO = (size_t)S * P * sB;  // field stride of out
  int32_t *st;
  size_t fS, nS;  // field and node strides of the store
  if (store_smem) {
    st = ring_code + 2 * T + (bc - b0);
    fS = L;
    nS = EX_FIELDS * L;
  } else {
    st = gstore + bc;
    fS = sB;
    nS = EX_FIELDS * sB;
  }
  const uint32_t last_bits =
      (N & 31) ? (1u << (N & 31)) - 1u : 0xFFFFFFFFu;  // of word NW - 1
  const int nchunks = (P + T - 1) / T;
  CycRing ring;
  int32_t flag = 0;
  for (int s = 0; s < S; ++s) {
    uint64_t eqw[5];
#pragma unroll
    for (int g = 0; g < 5; ++g)
      eqw[g] = ga_u64(eq[((size_t)(s * 5 + g) * 2) * sB + bc],
                      eq[((size_t)(s * 5 + g) * 2 + 1) * sB + bc]);
    const int32_t *prev_send =
        out + 5 * fO + (size_t)(s > 0 ? s - 1 : 0) * P * sB;
    int32_t *o = out + (size_t)s * P * sB + b;
    // the ring's chunks hold this slice's old_end; pass 1 takes every node
    ring.wait();
    ring.tag0 = ring.tag1 = -1;
    auto stage = [&](int c) {
      if (!ring.done(c)) ring.wait();  // a copy still landing there
      __syncwarp();  // and no thread still reads the buffer
      cyc_stage(ring_oe, ring_code, c, P, s, code, prev_send, b0, B, tid);
      ring.issued(c);
    };
    for (int i = tid; i < NW; i += 32) {
      need[i] = i + 1 < NW ? 0xFFFFFFFFu : last_bits;
      need[NW + i] = 0u;
    }
    __syncwarp();
    int cur = 0;
    bool changed;
    for (int pass = 1;; ++pass) {
      uint32_t *need_cur = need + cur * NW, *need_nxt = need + (cur ^ 1) * NW;
      bool lane_changed = pass == 1 && valid;
      int n_nodes = 0, n_pos = 0;
      for (int j = 0;;) {
        // the next node at or after j whose bit is set
        int w = j >> 5;
        if (w >= NW) break;
        uint32_t bits = need_cur[w] & (0xFFFFFFFFu << (j & 31));
        while (bits == 0u && ++w < NW) bits = need_cur[w];
        if (bits == 0u) break;
        j = (w << 5) + __ffs(bits) - 1;
        const int32_t n0 = tnodes[j];
        const int a = n0 >> 1, z = tnodes[j + 1] >> 1;
        const bool source0 = (n0 & 1) && s == 0;
        const int32_t *pj = tpred + (size_t)j * K;
        // pass 1 reads only the in-neighbours scheduled before j: the others
        // hold the reset store (sbs INF), which adds nothing to a merge
        const int lim = pass == 1 ? j : N;
        // pass >= 2: the previous pass's start column and stored end column,
        // each thread the two fields it writes (so no other thread's store
        // can come first): word sub and field 4 + (sub & 1)
        int32_t old_w = 0, old_f = 0, old_sw = 0, old_sf = 0;
        if (pass > 1 && valid) {
          old_w = o[sub * fO + (size_t)a * sB];
          old_f = o[(4 + (sub & 1)) * fO + (size_t)a * sB];
          old_sw = st[j * nS + sub * fS];
          old_sf = st[j * nS + (4 + (sub & 1)) * fS];
        }
        uint64_t vp = 0, vn = 0, eqc, eqc_n = 0;
        int32_t sbs = EX_INF, send = EX_INF, e = 0, oe, oe_n = 0;
        // position t's old_end and Eq word: staged where the node or a chunk
        // begins, else read a position early, off the previous one's chain
        auto fetch = [&](int t) {
          const int c = (unsigned)t / T, i = t - c * T;
          const int32_t *roe = ring_oe + (c & 1) * T * L + lane;
          const int32_t *rcode = ring_code + (c & 1) * T;
          if (t == a || i == 0) {
            if (ring.tag(c) != c) stage(c);
            if (!ring.done(c)) ring.wait();
            if (c + 1 < nchunks && ring.tag(c + 1) != c + 1) stage(c + 1);
            oe = s ? roe[i * L] : 0;
            eqc = ga_pick5(eqw, rcode[i]);
          } else {
            oe = oe_n;
            eqc = eqc_n;
          }
          if (i + 1 < T && t + 1 < z) {
            oe_n = s ? roe[(i + 1) * L] : 0;
            eqc_n = ga_pick5(eqw, rcode[i + 1]);
          }
        };
        // a column's word `sub` (vp lo, vp hi, vn lo, vn hi): each thread of
        // a lane writes one of them and field 4 + (sub & 1), so a column is
        // two stores of the whole warp
        auto word = [&]() {
          const uint64_t x = sub < 2 ? vp : vn;
          return (int32_t)(uint32_t)(sub & 1 ? x >> 32 : x);
        };
        auto put = [&](int t) {
          if (valid) {
            const size_t at = (size_t)t * sB;
            o[sub * fO + at] = word();
            o[(4 + (sub & 1)) * fO + at] = sub & 1 ? send : sbs;
          }
        };
        fetch(a);
        sbs = ex_step<G>(st, fS, nS, eqc, true, source0, pj, K, lim, oe, vp,
                         vn, sbs, send, e, lane, sub);
        e = sbs == oe;
        put(a);
        // a node's outputs follow from its start column: they change in this
        // pass iff the start column does (the lane's threads check a field
        // each, sbs and send twice)
        if (pass > 1 && valid)
          lane_changed |= word() != old_w || (sub & 1 ? send : sbs) != old_f;
        for (int t = a + 1; t < z; ++t) {
          fetch(t);
          sbs = ex_step<G>(st, fS, nS, eqc, false, false, pj, K, lim, oe, vp,
                           vn, sbs, send, e, lane, sub);
          e = sbs == oe;
          put(t);
        }
        // node j's end column (e in field 5), what later node starts read
        const bool end_changed =
            pass > 1 && valid &&
            (word() != old_sw || (sub & 1 ? e : sbs) != old_sf);
        if (valid) {
          st[j * nS + sub * fS] = word();
          st[j * nS + (4 + (sub & 1)) * fS] = sub & 1 ? e : sbs;
        }
        if (pass == 1) {
          // every end column changed from the reset store: j's back
          // in-neighbours (scheduled at or after j) are read anew in pass 2
          if (tid == 0) {
            bool back = false;
            for (int k = 0; k < K; ++k) back |= pj[k] >= j;
            if (back) need_nxt[j >> 5] |= 1u << (j & 31);
          }
        } else if (__ballot_sync(0xFFFFFFFFu, end_changed)) {
          // an out-neighbour after j is recomputed in this pass, one at or
          // before j in the next
          for (int q = succ_ptr[j] + tid; q < succ_ptr[j + 1]; q += 32) {
            const int v = succ[q];
            atomicOr(v > j ? &need_cur[v >> 5] : &need_nxt[v >> 5],
                     1u << (v & 31));
          }
        }
        __syncwarp();
        ++n_nodes;
        n_pos += z - a;
        ++j;
      }
      if (tid == 0) {
        int32_t *lg = plog + ((size_t)s * max_passes + pass - 1) * 3;
        atomicAdd(lg, 1);
        atomicAdd(lg + 1, n_nodes);
        atomicAdd(lg + 2, n_pos);
      }
      const unsigned any = __ballot_sync(0xFFFFFFFFu, lane_changed);
      if (pass >= max_passes || !any) {
        changed = (any >> lane) & 0x01010101u;  // any of the lane's threads
        break;
      }
      // the next pass takes this pass's next-generation bits
      for (int i = tid; i < NW; i += 32) need_cur[i] = 0u;
      cur ^= 1;
      __syncwarp();
    }
    if (changed) flag = 1;
    __syncwarp();  // this slice's send slab is read as the next's old_end
  }
  if (valid && sub == 0) nonconv[b] = flag;
}

// smem: the bytes of the layout above, computed by the wrapper
// (ops/exhaustive.py::cyclic_shape).
extern "C" int ga_exhaustive_cyclic(
    const int32_t *eq, const int32_t *code, const int32_t *nodes,
    const int32_t *npred, const int32_t *succ_ptr, const int32_t *succ,
    int32_t *out, int32_t *gstore, int32_t *nonconv, int32_t *plog, int S,
    int P, int K, int N, int B, int max_passes, int W, int table_smem,
    int store_smem, int smem, void *stream) {
  if (W < 1 || W > EX_CYC_MAX_WARPS || max_passes < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      exhaustive_cyclic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int L = 32 / EX_WAVE_G;
  const int warps = (B + L - 1) / L;
  exhaustive_cyclic_kernel<<<(warps + W - 1) / W, W * 32, smem,
                             (cudaStream_t)stream>>>(
      eq, code, nodes, npred, succ_ptr, succ, out, gstore, nonconv, plog, S,
      P, K, N, B, max_passes, W, table_smem, store_smem);
  return (int)cudaGetLastError();
}
