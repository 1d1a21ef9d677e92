// Iterative band projection (the pairwise branch of project_band in
// graphaligner_tpu/core/engine_banded.py) for sm_90a.
//
// One warp relaxes one read lane; thread t holds node slot t (Nm <= 32)
// and carries its topo rank from trip to trip. A trip forms the lane's
// valid entries: the slots, then the out-neighbours of each expanding
// slot, read warp-wide: the first EXP_HEAD entries of every expanding
// slot's row, 32 (slot, k) pairs a round and two rounds' loads in flight,
// then, a slot at a time, the rest of each row that filled those, 32
// entries a round up to its -1 pad (rows are -1 padded at their end, as
// core/tables.py builds them). Each valid entry becomes one 64-bit key,
// rank << 32 | pri << 22 | its concatenation index (the slots, then each
// slot's out-neighbours, slot-major; ops/project_band.py::sort_key), and a
// warp bitonic sort orders the E_v keys: up to 256 in registers, padded to
// a power of two, partners a shuffle away; past that in shared memory,
// padded virtually (O(E_v log^2 E_v / 32) steps a thread either way). That
// is the plain version's stable sort on (rank, pri): a node's entries lie
// together, its least pri first, the first of equals first. The head of
// each node's run is its kept entry and takes the slot counted by the heads
// before it; more than Nm heads set over. A kept entry's id and outp come
// from tables indexed by its concatenation index.
//
// What bounds it: each trip's chain of dependent loads (a row, then its
// entries' lengths and ranks) and the sort's steps, a few trips a slice;
// the card's floor (the bytes of the band, the rows and the outputs) is two
// orders of magnitude below (chip_smoke.py prints both).
//
// The stop rule couples the lanes: the JAX while_loop runs every lane for
// the same T iterations, the first at which no live lane (active and not
// over) changed, at most I_proj. A lane's "changed and live" flag, once
// false, stays false (over is sticky; an unchanged state is a fixpoint),
// so T is the largest of the lanes' own stops. Launch 0 runs each lane to
// its own stop s and atomic-maxes s into `trips`; a live lane is then
// final. A lane that stopped because it is not live, while its state still
// changed, keeps its state and s; launch 1 takes it on to T iterations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t EMPTY = 0x7fffffff;
constexpr int32_t INF_PRI = 1023;
constexpr int WORD = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr int EXP_HEAD = 4;        // a row's entries read in the first pass
constexpr int KEY_PRI_SHIFT = 22;  // key: rank << 32 | pri << 22 | index

struct Graph {
  const int32_t *out_nbrs, *node_len, *topo_rank;
  int K_out;
};

struct Tables {  // one warp's shared tables
  uint64_t *key;                             // [E] the trip's entries' keys
  int32_t *id, *outp;                        // [E] by concatenation index
  int32_t *sid, *soutp, *xslot, *slong;      // [Nm] slots, expanding slots
};

__device__ __forceinline__ uint64_t make_key(int32_t rank, int32_t pri,
                                             int idx) {
  return ((uint64_t)(uint32_t)rank << 32) |
         ((uint64_t)(uint32_t)pri << KEY_PRI_SHIFT) | (uint64_t)idx;
}

__device__ __forceinline__ void cswap(uint64_t *key, int lo, int hi) {
  const uint64_t a = key[lo], b = key[hi];
  if (a > b) {
    key[lo] = b;
    key[hi] = a;
  }
}

// Sorts 32 R keys held R a thread (element r * 32 + t in k[r] of thread t)
// ascending, with a bitonic network: each merge a mirror step, then
// half-cleaners; a partner within a register row is a lane shuffle away,
// one in another row is in the same thread.
template <int R>
__device__ __forceinline__ void sort_regs(uint64_t (&k)[R]) {
  const int t = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
    uint64_t o[R];
    if (size <= 32) {
      const bool low = (t & (size - 1)) < (size >> 1);
#pragma unroll
      for (int r = 0; r < R; ++r) o[r] = __shfl_xor_sync(FULL, k[r], size - 1);
#pragma unroll
      for (int r = 0; r < R; ++r) k[r] = low ? min(k[r], o[r]) : max(k[r], o[r]);
    } else {
      const int S = size / 32;  // register rows a block
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int rb = r & ~(S - 1);
        o[r] = __shfl_xor_sync(FULL, k[rb + S - 1 - (r - rb)], 31);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        k[r] = (r & (S - 1)) < S / 2 ? min(k[r], o[r]) : max(k[r], o[r]);
    }
#pragma unroll
    for (int d = size >> 2; d > 0; d >>= 1) {
      if (d >= 32) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int p = r ^ (d / 32);
          if (p > r) {
            const uint64_t a = k[r], b = k[p];
            k[r] = min(a, b);
            k[p] = max(a, b);
          }
        }
      } else {
        const bool low = (t & d) == 0;
#pragma unroll
        for (int r = 0; r < R; ++r) o[r] = __shfl_xor_sync(FULL, k[r], d);
#pragma unroll
        for (int r = 0; r < R; ++r)
          k[r] = low ? min(k[r], o[r]) : max(k[r], o[r]);
      }
    }
  }
}

template <int R>
__device__ __forceinline__ void sort_small(uint64_t *key, int n) {
  const int t = threadIdx.x & 31;
  uint64_t k[R];
#pragma unroll
  for (int r = 0; r < R; ++r) k[r] = r * 32 + t < n ? key[r * 32 + t] : ~0ull;
  sort_regs<R>(k);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r * 32 + t < n) key[r * 32 + t] = k[r];
}

// Sorts key[0 .. n) ascending. Up to 256 keys in registers (sort_regs,
// padded with the largest key); past that in shared memory: the same
// network over n padded to a power of two, where a comparator reaching
// past n would meet the padding's largest keys and is skipped.
__device__ void sort_keys(uint64_t *key, int n) {
  if (n <= 32) return sort_small<1>(key, n);
  if (n <= 64) return sort_small<2>(key, n);
  if (n <= 128) return sort_small<4>(key, n);
  if (n <= 256) return sort_small<8>(key, n);
  const int t = threadIdx.x & 31;
  int P2 = 1;
  while (P2 < n) P2 <<= 1;
  for (int size = 2; size <= P2; size <<= 1) {
    const int half = size >> 1;
    for (int i = t; i < P2 / 2; i += 32) {
      const int j = i & (half - 1);
      const int base = (i - j) << 1;
      if (base + size - 1 - j < n) cswap(key, base + j, base + size - 1 - j);
    }
    __syncwarp();
    for (int d = half >> 1; d > 0; d >>= 1) {
      for (int i = t; i < P2 / 2; i += 32) {
        const int lo = ((i & ~(d - 1)) << 1) + (i & (d - 1));
        if (lo + d < n) cswap(key, lo, lo + d);
      }
      __syncwarp();
    }
  }
}

// One relaxation iteration of the warp's lane. The thread's slot (id, pri,
// outp, rank) becomes the new one; `over` gains this iteration's band-size
// test. Returns whether any slot's id or pri changed (the same on every
// thread).
__device__ bool relax(const Tables &L, const Graph &g, int Nm, int ew,
                      int32_t &id, int32_t &pri, int32_t &outp,
                      int32_t &rank, bool &over) {
  const int t = threadIdx.x & 31;
  const unsigned below = (1u << t) - 1u;
  const int K = g.K_out;
  __syncwarp();
  // the slots: valid entries first, in slot order
  const bool sv = t < Nm && id < EMPTY && pri < INF_PRI;
  const unsigned sb = __ballot_sync(FULL, sv);
  int n = __popc(sb);
  if (sv) {
    L.key[__popc(sb & below)] = make_key(rank, pri, t);
    L.id[t] = id;
    L.outp[t] = outp;
  }
  // the expanding slots, in slot order
  const bool ex = t < Nm && id < EMPTY && outp <= ew && outp < INF_PRI;
  const unsigned xb = __ballot_sync(FULL, ex);
  if (ex) L.xslot[__popc(xb & below)] = t;
  if (t < Nm) {
    L.sid[t] = id;
    L.soutp[t] = outp;
    L.slong[t] = 0;
  }
  __syncwarp();
  // each expanding row's first W entries, 64 (slot, k) pairs an iteration
  const int W = min(K, EXP_HEAD);
  const int P = __popc(xb) * W;
  for (int q0 = 0; q0 < P; q0 += 64) {
    int32_t nb[2], s[2], k[2], len[2], rk[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = q0 + 32 * u + t;
      nb[u] = -1;
      s[u] = k[u] = 0;
      if (q < P) {
        const int r = q / W;
        k[u] = q - r * W;
        s[u] = L.xslot[r];
        nb[u] = g.out_nbrs[(int64_t)L.sid[s[u]] * K + k[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      len[u] = nb[u] >= 0 ? g.node_len[nb[u]] : 0;
      rk[u] = nb[u] >= 0 ? g.topo_rank[nb[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool v = nb[u] >= 0;
      const unsigned vb = __ballot_sync(FULL, v);
      if (v) {
        const int32_t p = L.soutp[s[u]];
        const int ci = Nm + s[u] * K + k[u];
        L.key[n + __popc(vb & below)] = make_key(rk[u], p, ci);
        L.id[ci] = nb[u];
        L.outp[ci] = min(p + len[u], INF_PRI);
        if (k[u] == W - 1 && W < K) L.slong[s[u]] = 1;
      }
      n += __popc(vb);
    }
  }
  __syncwarp();
  // the rest of each row that filled its first W entries, a slot at a time
  unsigned lb = __ballot_sync(FULL, t < Nm && L.slong[t]);
  while (lb) {
    const int s = __ffs(lb) - 1;
    lb &= lb - 1;
    const int32_t *row = g.out_nbrs + (int64_t)L.sid[s] * K;
    const int32_t p = L.soutp[s];
    for (int k0 = W; k0 < K; k0 += 32) {
      const int k = k0 + t;
      const int32_t nb = k < K ? row[k] : -1;
      const bool v = nb >= 0;
      const int32_t len = v ? g.node_len[nb] : 0;
      const int32_t rk = v ? g.topo_rank[nb] : 0;
      const unsigned vb = __ballot_sync(FULL, v);
      if (v) {
        const int ci = Nm + s * K + k;
        L.key[n + __popc(vb & below)] = make_key(rk, p, ci);
        L.id[ci] = nb;
        L.outp[ci] = min(p + len, INF_PRI);
      }
      n += __popc(vb);
      if (vb != FULL) break;  // the row's -1 pad, or its end
    }
  }
  __syncwarp();
  sort_keys(L.key, n);
  __syncwarp();
  // the head of each node's run is kept, in the slot of the heads before
  // it; the slot tables are free now and take the new slots
  int kept = 0;
  for (int i0 = 0; i0 < n && kept <= Nm; i0 += 32) {
    const int i = i0 + t;
    uint64_t ki = 0;
    bool head = false;
    if (i < n) {
      ki = L.key[i];
      head = i == 0 || (L.key[i - 1] >> 32) != (ki >> 32);
    }
    const unsigned hb = __ballot_sync(FULL, head);
    const int pos = kept + __popc(hb & below);
    if (head && pos < Nm) {
      const int ci = (int)(ki & ((1u << KEY_PRI_SHIFT) - 1u));
      L.sid[pos] = L.id[ci];
      L.xslot[pos] = (int32_t)((ki >> KEY_PRI_SHIFT) & 1023u);
      L.soutp[pos] = L.outp[ci];
      L.slong[pos] = (int32_t)(ki >> 32);
    }
    kept += __popc(hb);
  }
  __syncwarp();
  int32_t n_id = EMPTY, n_pri = INF_PRI, n_outp = INF_PRI, n_rank = 0;
  if (t < Nm && t < kept) {
    n_id = L.sid[t];
    n_pri = L.xslot[t];
    n_outp = L.soutp[t];
    n_rank = L.slong[t];
  }
  const bool changed = __any_sync(FULL, n_id != id || n_pri != pri);
  id = n_id;
  pri = n_pri;
  outp = n_outp;
  rank = n_rank;
  over = over || kept > Nm;
  return changed;
}

// mode 0: every lane from its previous band to its own stop; mode 1: the
// lanes that launch 0 left with a changing state, on to `trips` iterations
__global__ void project_band_kernel(
    int mode, const int32_t *__restrict__ p_ids,
    const int32_t *__restrict__ p_nmin, const int32_t *__restrict__ p_nend,
    const int32_t *__restrict__ p_min, const int32_t *__restrict__ bw,
    const uint8_t *__restrict__ act, Graph g, int32_t *ids, uint8_t *over_out,
    int32_t *pri_s, int32_t *outp_s, int32_t *stop, int32_t *trips,
    int64_t si0, int64_t si1, int64_t sm0, int64_t sm1, int64_t se0,
    int64_t se1, int Nm, int B, int I_proj, int LB) {
  extern __shared__ int32_t smem[];
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * LB + w;
  if (b >= B) return;  // the whole warp
  const int E = Nm * (1 + g.K_out);
  int32_t *base = smem + (int64_t)w * (4 * E + 4 * Nm);  // 8-byte aligned
  int32_t *tab = base + 2 * E;
  const Tables L{(uint64_t *)base, tab, tab + E, tab + 2 * E,
                 tab + 2 * E + Nm, tab + 2 * E + 2 * Nm, tab + 2 * E + 3 * Nm};
  const int32_t pmin = p_min[b], bwv = bw[b];
  const int ew = bwv + WORD;
  int32_t id = EMPTY, pri = INF_PRI, outp = INF_PRI, rank = 0;
  bool over = false;
  if (mode == 0) {
    if (t < Nm) {
      const int32_t pid = p_ids[b * si0 + t * si1];
      const int32_t nmin = p_nmin[b * sm0 + t * sm1];
      const int32_t nend = p_nend[b * se0 + t * se1];
      if (pid < EMPTY && nmin <= pmin + bwv) {
        id = pid;
        pri = 0;
        if (nend <= pmin + ew) outp = nend - pmin + 1;
        rank = g.topo_rank[id];
      }
    }
    const bool live_act = act[b] != 0;
    int it = 0;
    bool capped = false, cont = false;
    while (true) {
      const bool changed = relax(L, g, Nm, ew, id, pri, outp, rank, over);
      it++;
      if (!(changed && live_act && !over)) {
        cont = changed;  // a lane that is not live and still changing
        break;
      }
      if (it == I_proj) {
        capped = true;  // still improving at the cap
        break;
      }
    }
    if (t == 0) {
      atomicMax(trips, it);
      over_out[b] = over || capped;
      stop[b] = cont ? it : 0;
    }
    if (t < Nm) {
      ids[(int64_t)t * B + b] = id;
      if (cont) {
        pri_s[(int64_t)t * B + b] = pri;
        outp_s[(int64_t)t * B + b] = outp;
      }
    }
    return;
  }
  const int s = stop[b];
  if (s == 0) return;
  const int T = *trips;
  if (s >= T) return;
  if (t < Nm) {
    id = ids[(int64_t)t * B + b];
    pri = pri_s[(int64_t)t * B + b];
    outp = outp_s[(int64_t)t * B + b];
    if (id < EMPTY) rank = g.topo_rank[id];
  }
  over = over_out[b] != 0;
  for (int it = s; it < T; it++) relax(L, g, Nm, ew, id, pri, outp, rank, over);
  if (t == 0) over_out[b] = over;
  if (t < Nm) ids[(int64_t)t * B + b] = id;
}

}  // namespace

// ids [Nm, B] and over [B] out; pri_s, outp_s [Nm, B], stop [B] and
// trips [1] are scratch. The [B, Nm] inputs are read at (b * s0 + t * s1).
extern "C" int ga_project_band(
    const int32_t *p_ids, const int32_t *p_nmin, const int32_t *p_nend,
    const int32_t *p_min, const int32_t *bw, const uint8_t *act,
    const int32_t *out_nbrs, const int32_t *node_len,
    const int32_t *topo_rank, int32_t *ids, uint8_t *over, int32_t *pri_s,
    int32_t *outp_s, int32_t *stop, int32_t *trips, int si0, int si1,
    int sm0, int sm1, int se0, int se1, int Nm, int B, int K_out, int I_proj,
    int LB, int smem, void *stream) {
  if (Nm < 1 || Nm > 32 || K_out < 1 || I_proj < 1 || LB < 1 || LB > 32)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      project_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(trips, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const Graph g{out_nbrs, node_len, topo_rank, K_out};
  const int blocks = (B + LB - 1) / LB;
  for (int mode = 0; mode < 2; mode++) {
    project_band_kernel<<<blocks, LB * 32, smem, st>>>(
        mode, p_ids, p_nmin, p_nend, p_min, bw, act, g, ids, over, pri_s,
        outp_s, stop, trips, si0, si1, sm0, sm1, se0, se1, Nm, B, I_proj,
        LB);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
