// Iterative band projection (the pairwise branch of project_band in
// graphaligner_tpu/core/engine_banded.py) for sm_90a.
//
// One warp relaxes one read lane; thread t holds node slot t (Nm <= 32).
// An iteration writes the lane's valid entries (id, pri, outp, rank) into
// the warp's shared tables in concatenation order (the slots, then each
// slot's out-neighbours, slot-major), compacted by a ballot and a prefix
// sum; keeps each node's entry of least pri (the first of equals); and
// places the kept nodes by topo rank, the first Nm into the slots. Both
// the dedup and the placement compare every entry with every other one,
// E_v * E_v / 32 steps a thread over the E_v valid entries.
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
constexpr int32_t NOT_KEPT = 0x7fffffff;  // rank of an entry not kept
constexpr int WORD = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Graph {
  const int32_t *out_nbrs, *node_len, *topo_rank;
  int K_out;
};

struct Tables {  // one warp's shared tables
  int32_t *id, *pri, *outp, *rank;  // [E]
  int32_t *nid, *npri, *noutp;      // [Nm]
};

// One relaxation iteration of the warp's lane. The thread's slot (id, pri,
// outp) becomes the new one; `over` gains this iteration's band-size test.
// Returns whether any slot's id or pri changed (the same on every thread).
__device__ bool relax(const Tables &L, const Graph &g, int Nm, int ew,
                      int32_t &id, int32_t &pri, int32_t &outp, bool &over) {
  const int t = threadIdx.x & 31;
  const unsigned below = (1u << t) - 1u;
  // the slots: valid entries first, in slot order
  const bool sv = t < Nm && id < EMPTY && pri < INF_PRI;
  const unsigned sb = __ballot_sync(FULL, sv);
  const int n_slot = __popc(sb);
  if (sv) {
    const int e = __popc(sb & below);
    L.id[e] = id;
    L.pri[e] = pri;
    L.outp[e] = outp;
    L.rank[e] = g.topo_rank[id];
  }
  // the candidates: each slot's out-neighbours, after every slot entry
  const bool expand = t < Nm && id < EMPTY && outp <= ew;
  const int32_t *nbrs = g.out_nbrs + (int64_t)(expand ? id : 0) * g.K_out;
  int c = 0;
  if (expand)
    for (int k = 0; k < g.K_out; k++) c += nbrs[k] >= 0;
  int incl = c;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (t >= d) incl += v;
  }
  const int E_v = n_slot + __shfl_sync(FULL, incl, 31);
  if (expand) {
    int e = n_slot + incl - c;
    for (int k = 0; k < g.K_out; k++) {
      const int32_t nb = nbrs[k];
      if (nb < 0) continue;
      L.id[e] = nb;
      L.pri[e] = outp;
      L.outp[e] = min(outp + g.node_len[nb], INF_PRI);
      L.rank[e] = g.topo_rank[nb];
      e++;
    }
  }
  __syncwarp();
  // dedup: an entry is kept when no entry of its node has a smaller pri,
  // or an equal one earlier; a dropped entry's rank becomes NOT_KEPT
  int kept = 0;
  for (int i = t; i < E_v; i += 32) {
    const int32_t idi = L.id[i], pi = L.pri[i];
    bool keep = true;
    for (int j = 0; j < E_v; j++) {
      const int32_t pj = L.pri[j];
      keep &= !(L.id[j] == idi && (pj < pi || (pj == pi && j < i)));
    }
    kept += keep;
    if (!keep) L.rank[i] = NOT_KEPT;
  }
  __syncwarp();
  // placement: a kept entry's slot is the number of kept ranks below its
  // own (ranks are unique a node)
  for (int i = t; i < E_v; i += 32) {
    const int32_t ri = L.rank[i];
    if (ri == NOT_KEPT) continue;
    int pos = 0;
    for (int j = 0; j < E_v; j++) pos += L.rank[j] < ri;
    if (pos < Nm) {
      L.nid[pos] = L.id[i];
      L.npri[pos] = L.pri[i];
      L.noutp[pos] = L.outp[i];
    }
  }
  for (int d = 16; d > 0; d >>= 1) kept += __shfl_xor_sync(FULL, kept, d);
  __syncwarp();
  int32_t n_id = EMPTY, n_pri = INF_PRI, n_outp = INF_PRI;
  if (t < Nm && t < kept) {
    n_id = L.nid[t];
    n_pri = L.npri[t];
    n_outp = L.noutp[t];
  }
  const bool changed = __any_sync(FULL, n_id != id || n_pri != pri);
  id = n_id;
  pri = n_pri;
  outp = n_outp;
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
  int32_t *base = smem + (int64_t)w * (4 * E + 3 * Nm);
  const Tables L{base, base + E, base + 2 * E, base + 3 * E, base + 4 * E,
                 base + 4 * E + Nm, base + 4 * E + 2 * Nm};
  const int32_t pmin = p_min[b], bwv = bw[b];
  const int ew = bwv + WORD;
  int32_t id = EMPTY, pri = INF_PRI, outp = INF_PRI;
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
      }
    }
    const bool live_act = act[b] != 0;
    int it = 0;
    bool capped = false, cont = false;
    while (true) {
      const bool changed = relax(L, g, Nm, ew, id, pri, outp, over);
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
  }
  over = over_out[b] != 0;
  for (int it = s; it < T; it++) relax(L, g, Nm, ew, id, pri, outp, over);
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
