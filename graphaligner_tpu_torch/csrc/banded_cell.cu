// One banded slice, its metadata pass fused with its cell passes (kernel
// K1) for Hopper, sm_90a.
//
// Replaces graphaligner_tpu/ops/pallas/banded_cell.py::banded_cell_kernel
// together with the per-slice torch code around it in graphaligner_tpu/
// core/engine_banded.py::banded_scan (between the band projection and the
// packed outputs): from the projected band and the previous slice's
// carries, the per-slot tables, the lane's Eq words and the per-cell
// metadata; then all Cm band cells in order — the within-node Myers
// advance, the fused boundary / pseudo / band-source column, the
// differenceMasks merge over the in-band predecessors read from the
// node-end buffer, the node-end buffer writes and the per-slot minima —
// repeated to a bounded fixpoint on lanes whose band has a back edge; then
// the slice's outputs (cols, the nm_pack fields, the control word) and the
// next carries, each masked by the lane's active flag.
//
// Design: a block carries LB lanes, all of its state in shared memory,
// lane-minor ([x][LB], so the lanes of a warp hit distinct banks):
// - phase A, one thread per (lane, slot), a warp per lane: the slot
//   tables — lengths and starts, the previous-band match (node_in_prev,
//   prev_slot, prev_base by a warp scan), the in-neighbour classification
//   (slot_pseudo, pred_tab, pred_prev, the band-source flags), cum_end by a
//   warp scan — and the lane's five Eq words, from its 64 read codes by
//   warp ballots;
// - phase A2, one thread per (lane, cell): each cell's packed metadata word
//   and old_end, the global loads (seq_codes, p_cell_send) off the serial
//   chain;
// - phase B, one thread per lane: the cells in order with the column in
//   registers (uint64_t vp/vn), the node-end buffer and slot minima in
//   shared memory, cols written once per pass, coalesced (batch last);
// - phase C, one thread per (lane, slot) again: minima, outputs, carries.
// No metadata array goes to device memory; the host launches one kernel a
// slice where the torch code launched about two hundred.
//
// The cyclic fixpoint runs per lane: a lane with a back edge (an in-band
// predecessor at a slot >= the node's own) repeats the pass from the
// previous pass's node-end buffer until its cols stop changing, at most
// P_fix more passes, and is flagged if its last pass still changed them.
// This is exactly the torch loop's result, which repeats passes for every
// lane while any back-edge lane changes: buf and nmin are functions of cols
// and buf_init (buf_out = buf_init overwritten at the node ends, from cols),
// so a lane whose cols did not change between two passes has the same buf
// and nmin too, and every later pass reproduces it; a lane still changing
// at the last pass is flagged there as here. A lane without a back edge
// reads at each node start only ends written earlier in the same pass, so
// its first pass is already its fixpoint.
//
// What bounds it: the card's floor is the bytes of the slice's inputs and
// outputs (the carries, the band, the read-code window, the graph-table
// entries the band names; cols, nm_pack, ctrl and the next carries), 6.4 MB
// at Cm=288, Nm=32, B=512 on longsim, 1.9 us at 3.35 TB/s, above its 14.9 M
// int32 operations; the kernel takes 0.14 ms there (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py), a share of 0.014. One thread per lane walks the
// cells serially, so the pass is latency-bound; the design keeps the
// serial part to the DP itself (its metadata in shared memory, written
// beforehand by all threads), and blocks of 8 lanes spread a round's lanes
// over many SMs and keep the divergence between start and chain cells to 8
// lanes a warp.
//
// The wide route (slice_cells_kernel<true>, past 5 in-neighbours) is the
// JAX package's XLA cell pass (graphaligner_tpu/core/engine_banded.py::
// cell_pass_xla), which it runs past 5 in-neighbours and which merges the
// same predecessors in the same order. Its pred tables take NP = ceil(K_in /
// 5) int32 planes each of pred_tab and pred_prev (plane p holds
// in-neighbours 5p to 5p + 4, 6 bits each: a 5-bit slot, Nm <= 32, and its
// valid bit), written to nm rows 4 .. 4 + 2 NP - 1 from the registers that
// pack them; nothing reads them back. What bounds it is phase B's node
// starts: a joining node merges each of its in-band predecessors in turn,
// and the lanes of a warp that are not at a node start wait. So:
// - phase A classifies each in-neighbour in O(1), through a per-lane hash
//   table of both bands' node ids (HT_SIZE buckets, open addressing; the
//   first slot holding a node wins, as the scans of the narrow route find
//   it), each slot thread reading its own row eight entries at a time up to
//   the row's -1 pad (rows are -1 padded at their end, as core/tables.py
//   builds them), and keeps each slot's in-band predecessor slots as a
//   compact list of bytes in in-neighbour order (at most Nm a slot: more
//   than Nm in-band entries needs a repeated in-neighbour, and such a slot
//   reads its row again at its node start, through the same table);
// - phase B's node starts loop over that list only;
// - a block carries fewer lanes (WIDE_LANES in ops/banded_cell.py), so
//   fewer lanes share phase B's warp and more blocks fill the SMs.
// Its shared memory no longer grows with K_in: no in-degree bound is left.
#include <cuda_runtime.h>

#include "wordops.cuh"

#define SC_EMPTY 0x7FFFFFFF
#define SC_FULL 0xFFFFFFFFu

// shared tables, each [n][LB] int32 (t = table index, x = row)
#define SLOT(t, x) sm[((t) * Nm + (x)) * LB + l]
enum {
  T_IDS, T_PIDS, T_PEND, T_LEN, T_CUM, T_START, T_INPREV, T_PBASE, T_PSEUDO,
  T_PTAB, T_PPREV, T_SRC, T_POFF, T_NMIN, T_BUF,  // T_BUF: 7 tables
  T_SLOTS = T_BUF + 7
};
// wide: T_PTAB holds a slot's in-band list length (-1: read the row), and
// the hash table's keys and values follow the lane words, then the lists

#define HT_SIZE 128  // hash buckets a lane, for at most 2 Nm = 64 keys

__device__ __forceinline__ uint32_t ht_hash(int32_t x) {
  return ((uint32_t)x * 2654435769u) >> 25;  // 7 bits
}

// The value of node x (>= 0) in a lane's table: the first current slot
// holding it | valid << 5 in bits 0-5, the first previous slot | valid << 5
// in bits 8-13; 0 when neither band holds it.
__device__ __forceinline__ int32_t ht_get(const int32_t *hk,
                                          const int32_t *hv, int LB, int l,
                                          int32_t x) {
  uint32_t h = ht_hash(x);
  while (true) {
    const int32_t k = hk[h * LB + l];
    if (k == x) return hv[h * LB + l];
    if (k == SC_EMPTY) return 0;
    h = (h + 1) & (HT_SIZE - 1);
  }
}

// Adds `bits` to node x's value (inserting x). One thread a key at a time.
__device__ __forceinline__ void ht_put(int32_t *hk, int32_t *hv, int LB,
                                       int l, int32_t x, int32_t bits) {
  uint32_t h = ht_hash(x);
  while (true) {
    const int32_t old = atomicCAS(&hk[h * LB + l], SC_EMPTY, x);
    if (old == SC_EMPTY || old == x) {
      hv[h * LB + l] |= bits;
      return;
    }
    h = (h + 1) & (HT_SIZE - 1);
  }
}

template <bool WIDE>
__global__ void slice_cells_kernel(
    const int32_t *__restrict__ ids,         // [Nm, B]
    const uint8_t *__restrict__ proj_over,   // [B]
    const int32_t *__restrict__ p_ids,       // [Nm, B]
    const int32_t *__restrict__ p_node_min,  // [Nm, B]
    const int32_t *__restrict__ p_node_end,  // [Nm, B]
    const int32_t *__restrict__ p_cell_send, // [Cm, B]
    const int32_t *__restrict__ p_min,       // [B]
    const uint8_t *__restrict__ active,      // [B]
    const uint8_t *__restrict__ first_slice, // [B]
    const int32_t *__restrict__ seq_len,     // [B]
    const uint8_t *__restrict__ read_codes,  // [B, Lc]
    const int32_t *__restrict__ win,         // [B]
    const int32_t *__restrict__ node_len,    // [N]
    const int32_t *__restrict__ node_start,  // [N]
    const int32_t *__restrict__ in_nbrs,     // [N, K_in]
    const int32_t *__restrict__ seq_codes,   // [BP]
    const int32_t *__restrict__ bits_lut,    // [R]
    int32_t *__restrict__ cols,              // [7, Cm, B]
    int32_t *__restrict__ nm,                // [4 + 2 NP, Nm, B]
    int32_t *__restrict__ ctrl,              // [B]
    int32_t *__restrict__ o_ids,             // [Nm, B]
    int32_t *__restrict__ o_cell_send,       // [Cm, B]
    int32_t *__restrict__ o_node_min,        // [Nm, B]
    int32_t *__restrict__ o_node_end,        // [Nm, B]
    int32_t *__restrict__ o_min,             // [B]
    int Nm, int Cm, int B, int N, int K_in, int BP, int Lc, int P_fix,
    int LB) {
  extern __shared__ int32_t sm[];
  const int NP = WIDE ? (K_in + 4) / 5 : 1;  // pred planes
  int32_t *sm_m1 = sm + T_SLOTS * Nm * LB;  // [Cm][LB]
  int32_t *sm_oe = sm_m1 + Cm * LB;         // [Cm][LB]
  int32_t *sm_lane = sm_oe + Cm * LB;       // [12][LB]: eq lo/hi x 5, c_used, fail
  // wide: the hash tables [HT_SIZE][LB] and the in-band lists [Nm * Nm][LB]
  int32_t *sm_hk = sm_lane + 12 * LB;
  int32_t *sm_hv = sm_hk + HT_SIZE * LB;
  uint8_t *sm_list = (uint8_t *)(sm_hv + HT_SIZE * LB);
  const size_t sB = (size_t)B;

  // ---- phase A: one warp per lane, one thread per slot
  {
    const int l = threadIdx.x >> 5, j = threadIdx.x & 31;
    const int b = blockIdx.x * LB + l;
    if (b < B) {
      const bool sj = j < Nm;
      const int32_t id = sj ? ids[j * sB + b] : SC_EMPTY;
      const int32_t pid = sj ? p_ids[j * sB + b] : SC_EMPTY;
      const bool valid = id < SC_EMPTY, pvalid = pid < SC_EMPTY;
      const int safe = min(max(id, 0), N - 1);
      const int32_t len = valid ? node_len[safe] : 0;
      const int32_t plen = pvalid ? node_len[min(max(pid, 0), N - 1)] : 0;
      int32_t cum = len, pcum = plen;  // inclusive warp scans
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t a = __shfl_up_sync(SC_FULL, cum, d);
        const int32_t pa = __shfl_up_sync(SC_FULL, pcum, d);
        if (j >= d) {
          cum += a;
          pcum += pa;
        }
      }
      const int32_t c_used = __shfl_sync(SC_FULL, cum, 31);
      if (sj) {
        SLOT(T_IDS, j) = id;
        SLOT(T_PIDS, j) = pid;
        SLOT(T_PEND, j) = p_node_end[j * sB + b];
        SLOT(T_LEN, j) = len;
        SLOT(T_CUM, j) = cum;
        SLOT(T_START, j) = valid ? node_start[safe] : 0;
        SLOT(T_POFF, j) = pcum - plen;
      }
      // Eq words: rows j and j + 32 of the lane's window
      const int base = min(max(win[b] * 64, 0), Lc - 64);
      const uint8_t *rc = read_codes + (size_t)b * Lc + base;
      const int32_t bl = bits_lut[rc[j]], bh = bits_lut[rc[j + 32]];
#pragma unroll
      for (int g = 0; g < 5; ++g) {
        const uint32_t lo = __ballot_sync(SC_FULL, (bl >> g) & 1);
        const uint32_t hi = __ballot_sync(SC_FULL, (bh >> g) & 1);
        if (j == 0) {
          sm_lane[(2 * g) * LB + l] = (int32_t)lo;
          sm_lane[(2 * g + 1) * LB + l] = (int32_t)hi;
        }
      }
      if (j == 0) {
        sm_lane[10 * LB + l] = c_used;
        sm_lane[11 * LB + l] = 0;
      }
      __syncwarp();
      if constexpr (WIDE) {
        // the lane's hash table of both bands' ids: the lowest slot of
        // each distinct id inserts it (the first slot holding it wins)
        for (int h = j; h < HT_SIZE; h += 32) {
          sm_hk[h * LB + l] = SC_EMPTY;
          sm_hv[h * LB + l] = 0;
        }
        __syncwarp();
        const unsigned below = (1u << j) - 1u;
        const unsigned same = __match_any_sync(SC_FULL, id);
        if (valid && !(same & below)) ht_put(sm_hk, sm_hv, LB, l, id, j | 32);
        __syncwarp();
        const unsigned psame = __match_any_sync(SC_FULL, pid);
        if (pvalid && !(psame & below))
          ht_put(sm_hk, sm_hv, LB, l, pid, (j | 32) << 8);
        __syncwarp();
      }
      if (sj) {
        bool inprev = false;
        int prev_slot = 0;
        if constexpr (WIDE) {
          const int32_t v = valid ? ht_get(sm_hk, sm_hv, LB, l, id) : 0;
          inprev = (v >> 13) & 1;
          prev_slot = (v >> 8) & 31;
        } else {
          // previous-band match: the first previous slot holding this node
          for (int i = 0; i < Nm; ++i) {
            const int32_t q = SLOT(T_PIDS, i);
            if (valid && q < SC_EMPTY && q == id) {
              inprev = true;
              prev_slot = i;
              break;
            }
          }
        }
        SLOT(T_INPREV, j) = inprev;
        SLOT(T_PBASE, j) = SLOT(T_POFF, prev_slot);
        bool any_banded = false;
        int32_t pseudo = GA_INF;
        const bool act = active[b];
        if constexpr (WIDE) {
          // in-neighbour classification: the row eight entries at a time,
          // up to its -1 pad; pred planes packed in registers and stored
          const int32_t *row = in_nbrs + (size_t)safe * K_in;
          uint8_t *lst = sm_list + (size_t)j * Nm * LB + l;
          int32_t ptab = 0, pprev = 0;
          int n_in = 0, p = 0, sh = 0;
          bool more = valid;
          for (int k0 = 0; more; k0 += 8) {
            int32_t nbv[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              nbv[u] = k0 + u < K_in ? __ldg(row + k0 + u) : -1;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int32_t nb = nbv[u];
              if (nb < 0) {
                more = false;
                break;
              }
              const int32_t v = ht_get(sm_hk, sm_hv, LB, l, nb);
              const int32_t fc = v & 63, fp = (v >> 8) & 63;
              const bool in_cur = fc >> 5, in_prev = fp >> 5;
              if (in_prev && !in_cur)
                pseudo = min(pseudo, SLOT(T_PEND, fp & 31));
              any_banded |= in_cur || in_prev;
              if (in_cur) {
                if (n_in < Nm) lst[(size_t)n_in * LB] = (uint8_t)(fc & 31);
                ++n_in;
              }
              ptab |= fc << sh;
              pprev |= fp << sh;
              sh += 6;
              if (sh == 30) {
                nm[((4 + p) * Nm + j) * sB + b] = act ? ptab : 0;
                nm[((4 + NP + p) * Nm + j) * sB + b] = act ? pprev : 0;
                ++p;
                ptab = pprev = sh = 0;
              }
            }
          }
          for (; p < NP; ++p) {  // the row's last plane, then empty ones
            nm[((4 + p) * Nm + j) * sB + b] = act ? ptab : 0;
            nm[((4 + NP + p) * Nm + j) * sB + b] = act ? pprev : 0;
            ptab = pprev = 0;
          }
          SLOT(T_PTAB, j) = n_in <= Nm ? n_in : -1;
        } else {
          // in-neighbour classification, five in-neighbours a plane
          int32_t ptab = 0, pprev = 0;
          for (int k = 0; k < 5 && k < K_in; ++k) {
            const int32_t nb = valid ? in_nbrs[(size_t)safe * K_in + k] : -1;
            const bool nbv = nb >= 0 && valid;
            bool in_cur = false, in_prev = false;
            int cur_slot = 0, pslot = 0;
            if (nbv) {
              for (int i = 0; i < Nm; ++i)
                if (SLOT(T_IDS, i) == nb) {
                  in_cur = true;
                  cur_slot = i;
                  break;
                }
              for (int i = 0; i < Nm; ++i) {
                const int32_t q = SLOT(T_PIDS, i);
                if (q < SC_EMPTY && q == nb) {
                  in_prev = true;
                  pslot = i;
                  break;
                }
              }
            }
            const int32_t pe = in_prev ? SLOT(T_PEND, pslot) : GA_INF;
            if (in_prev && !in_cur) pseudo = min(pseudo, pe);
            any_banded |= in_cur || in_prev;
            ptab |= (cur_slot | ((int32_t)in_cur << 5)) << (6 * k);
            pprev |= (pslot | ((int32_t)in_prev << 5)) << (6 * k);
          }
          SLOT(T_PTAB, j) = ptab;
          SLOT(T_PPREV, j) = pprev;
          nm[(4 * Nm + j) * sB + b] = act ? ptab : 0;
          nm[(5 * Nm + j) * sB + b] = act ? pprev : 0;
        }
        const bool band_source = !any_banded && valid;
        SLOT(T_PSEUDO, j) = pseudo;
        SLOT(T_SRC, j) = (int32_t)(band_source && !inprev) |
                         ((int32_t)(band_source && inprev && first_slice[b])
                          << 1);
        // node-end buffer at INF
        SLOT(T_BUF + 0, j) = -1;
        SLOT(T_BUF + 1, j) = -1;
        SLOT(T_BUF + 2, j) = 0;
        SLOT(T_BUF + 3, j) = 0;
        SLOT(T_BUF + 4, j) = GA_INF;
        SLOT(T_BUF + 5, j) = GA_INF + 64;
        SLOT(T_BUF + 6, j) = 0;
        // outputs that do not depend on the cell pass
        nm[(0 * Nm + j) * sB + b] = act ? id : SC_EMPTY;
        nm[(3 * Nm + j) * sB + b] = act ? len : 0;
        o_ids[j * sB + b] = act ? id : pid;
      }
    }
  }
  __syncthreads();

  // ---- phase A2: one thread per (lane, cell): metadata word and old_end
  for (int i = threadIdx.x; i < Cm * LB; i += blockDim.x) {
    const int l = i % LB, c = i / LB;
    const int b = blockIdx.x * LB + l;
    if (b >= B) continue;
    const int32_t c_used = sm_lane[10 * LB + l];
    int cnt = 0;
    for (int jj = 0; jj < Nm; ++jj)
      cnt += SLOT(T_CUM, jj) <= c && SLOT(T_LEN, jj) > 0;
    const int slot = min(cnt, Nm - 1);
    const int32_t len_s = SLOT(T_LEN, slot);
    const int32_t off = c - (SLOT(T_CUM, slot) - len_s);
    const bool vc = c < c_used && len_s > 0;
    const bool st = off == 0 && vc;
    const bool en = off == len_s - 1 && vc;
    const bool inprev = SLOT(T_INPREV, slot) != 0;
    const int pos = min(max(SLOT(T_START, slot) + off, 0), BP - 1);
    const int32_t code = vc ? seq_codes[pos] : 4;
    const int old_idx = min(max(SLOT(T_PBASE, slot) + off, 0), Cm - 1);
    const int32_t src = st ? SLOT(T_SRC, slot) : 0;
    sm_m1[c * LB + l] = slot | ((int32_t)st << 8) | ((int32_t)en << 9) |
                        ((int32_t)vc << 10) | ((int32_t)inprev << 11) |
                        (code << 12) | ((src & 1) << 15) | ((src >> 1) << 16);
    sm_oe[c * LB + l] =
        inprev && vc ? p_cell_send[(size_t)old_idx * sB + b] : GA_INF;
    if (!active[b]) o_cell_send[c * sB + b] = p_cell_send[c * sB + b];
  }
  __syncthreads();

  // ---- phase B: one thread per lane, the cell passes
  if (threadIdx.x < LB && blockIdx.x * LB + threadIdx.x < B) {
    const int l = threadIdx.x;
    const int b = blockIdx.x * LB + l;
    const bool act = active[b];
    uint64_t eqw[5];
#pragma unroll
    for (int g = 0; g < 5; ++g)
      eqw[g] = ga_u64(sm_lane[(2 * g) * LB + l], sm_lane[(2 * g + 1) * LB + l]);
    const int32_t slen = seq_len[b];
    const size_t fC = (size_t)Cm * sB;  // field stride of cols
    bool back_edge = false;
    int pass = 0;
    while (true) {
      ++pass;
      bool diff = false;
      for (int j = 0; j < Nm; ++j) SLOT(T_NMIN, j) = GA_INF;
      Col col = {~0ull, 0ull, GA_INF, GA_INF + 64, 0};
      for (int c = 0; c < Cm; ++c) {
        const int32_t meta = sm_m1[c * LB + l];
        const int slot = meta & 0xFF;
        const bool st = (meta >> 8) & 1;
        const bool en = (meta >> 9) & 1;
        const bool vc = (meta >> 10) & 1;
        const bool inprev = (meta >> 11) & 1;
        const int code = (meta >> 12) & 7;
        Col n;
        if (!vc) {
          n.vp = ~0ull;
          n.vn = 0ull;
          n.sbs = GA_INF;
          n.send = GA_INF + 64;
        } else {
          const int32_t oe = sm_oe[c * LB + l];
          const uint64_t eq = ga_pick5(eqw, code);
          if (st) {
            // fused uniform column (boundary / pseudo / band source)
            const bool srcnp = (meta >> 15) & 1;
            const bool srcsm = (meta >> 16) & 1;
            const int32_t ps = SLOT(T_PSEUDO, slot);
            const int32_t match0 = (int32_t)(eq & 1ull);
            const int32_t sm0 = srcsm ? 1 - match0 : 1;
            const int32_t sbs_b = inprev ? oe : GA_INF;
            const int32_t a_b = inprev ? oe + sm0 : GA_INF + 1;
            const bool has_ps = ps < GA_INF;
            const int32_t sbs_p = has_ps ? ps + 1 : GA_INF;
            const int32_t a_p = has_ps ? ps + 1 - match0 : GA_INF + 1;
            const int32_t sbs_s = srcnp ? slen + 1 : GA_INF;
            const int32_t a_s = srcnp ? slen + 2 : GA_INF + 1;
            const int32_t sbs_f = min(min(sbs_b, sbs_p), sbs_s);
            const int32_t a_f = min(min(a_b, a_p), a_s);
            const int32_t delta = a_f - sbs_f;
            Col merged;
            merged.vp = 0xFFFFFFFFFFFFFFFEull | (delta == 1 ? 1ull : 0ull);
            merged.vn = delta == -1 ? 1ull : 0ull;
            merged.sbs = sbs_f;
            merged.send = a_f + 63;
            merged.e = 0;
            // in-band predecessor columns (getNodeStartSlice), in
            // in-neighbour order
            auto merge_pred = [&](int pslot) {
              if (pslot >= slot) back_edge = true;
              int32_t g[7] = {0, 0, 0, 0, 0, 0, 0};
              if (pslot < Nm)
                for (int f = 0; f < 7; ++f) g[f] = SLOT(T_BUF + f, pslot);
              Col adv;
              int32_t a_send;
              myers_advance((g[6] & 1) ? eq : (eq & ~1ull),
                            ga_u64(g[0], g[1]), ga_u64(g[2], g[3]), g[5], 1,
                            adv.vp, adv.vn, a_send);
              adv.sbs = g[4] + 1;
              adv.send = a_send;
              adv.e = g[6];
              merged = merge_slices(merged, adv);
            };
            if constexpr (WIDE) {
              const int32_t n_in = SLOT(T_PTAB, slot);
              if (n_in >= 0) {
                const uint8_t *lst = sm_list + (size_t)slot * Nm * LB + l;
                for (int i = 0; i < n_in; ++i) merge_pred(lst[(size_t)i * LB]);
              } else {
                // more in-band entries than slots: the row again
                const int32_t *row =
                    in_nbrs + (size_t)min(max(SLOT(T_IDS, slot), 0), N - 1) *
                                  K_in;
                for (int k = 0; k < K_in; ++k) {
                  const int32_t nb = row[k];
                  if (nb < 0) break;
                  const int32_t v = ht_get(sm_hk, sm_hv, LB, l, nb);
                  if (v & 32) merge_pred(v & 31);
                }
              }
            } else {
              const int32_t rp = SLOT(T_PTAB, slot);
              for (int k = 0; k < 5 && k < K_in; ++k)
                if ((rp >> (6 * k + 5)) & 1) merge_pred((rp >> (6 * k)) & 31);
            }
            n.vp = merged.vp;
            n.vn = merged.vn;
            n.sbs = merged.sbs;
            n.send = merged.send;
          } else {
            // within-node chain advance
            const int32_t r_chain = min(oe, col.sbs + 1);
            myers_advance((col.e & 1) ? eq : (eq & ~1ull), col.vp, col.vn,
                          col.send, r_chain - col.sbs, n.vp, n.vn, n.send);
            n.sbs = r_chain;
          }
          n.e = (inprev && n.sbs == oe) ? 1 : 0;
        }
        // field 6: bit0 = scoreBeforeExists, bits 1-3 = the cell's code
        if (!vc) n.e = 0;
        n.e |= code << 1;
        const int32_t fields[7] = {
            (int32_t)(uint32_t)n.vp, (int32_t)(uint32_t)(n.vp >> 32),
            (int32_t)(uint32_t)n.vn, (int32_t)(uint32_t)(n.vn >> 32),
            n.sbs, n.send, n.e};
        int32_t *o = cols + (size_t)c * sB + b;
        if (pass > 1)
          for (int f = 0; f < 7; ++f) diff |= o[f * fC] != fields[f];
        for (int f = 0; f < 7; ++f) o[f * fC] = fields[f];
        if (act) o_cell_send[c * sB + b] = n.send;
        if (vc && slot < Nm) {
          if (en)
            for (int f = 0; f < 7; ++f) SLOT(T_BUF + f, slot) = fields[f];
          SLOT(T_NMIN, slot) = min(SLOT(T_NMIN, slot), n.send);
        }
        col = n;
      }
      if (pass == 1 ? !back_edge : !diff) break;
      if (pass == P_fix + 1) {
        sm_lane[11 * LB + l] = 1;  // still changing at the last pass
        break;
      }
    }
  }
  __syncthreads();

  // ---- phase C: one warp per lane, one thread per slot
  {
    const int l = threadIdx.x >> 5, j = threadIdx.x & 31;
    const int b = blockIdx.x * LB + l;
    if (b < B) {
      const bool sj = j < Nm;
      const int32_t nmin = sj ? SLOT(T_NMIN, j) : GA_INF;
      const int32_t nend = sj ? SLOT(T_BUF + 5, j) : GA_INF;
      int32_t m = sj && SLOT(T_IDS, j) < SC_EMPTY ? nmin : GA_INF;
#pragma unroll
      for (int d = 16; d; d >>= 1) m = min(m, __shfl_xor_sync(SC_FULL, m, d));
      const bool act = active[b];
      if (sj) {
        nm[(1 * Nm + j) * sB + b] = act ? nmin : GA_INF;
        nm[(2 * Nm + j) * sB + b] = act ? nend : GA_INF;
        o_node_min[j * sB + b] = act ? nmin : p_node_min[j * sB + b];
        o_node_end[j * sB + b] = act ? nend : SLOT(T_PEND, j);
      }
      if (j == 0) {
        const int32_t c_used = sm_lane[10 * LB + l];
        const bool over =
            proj_over[b] || c_used > Cm || sm_lane[11 * LB + l] != 0;
        const int32_t pm = p_min[b];
        ctrl[b] = act ? (min(max(m - pm, 0), 127) | (min(c_used, Cm) << 7) |
                         ((int32_t)over << 30))
                      : 0;
        o_min[b] = act ? m : pm;
      }
    }
  }
}

template <bool WIDE>
static int launch_slice_cells(
    const int32_t *ids, const uint8_t *proj_over, const int32_t *p_ids,
    const int32_t *p_node_min, const int32_t *p_node_end,
    const int32_t *p_cell_send, const int32_t *p_min, const uint8_t *active,
    const uint8_t *first_slice, const int32_t *seq_len,
    const uint8_t *read_codes, const int32_t *win, const int32_t *node_len,
    const int32_t *node_start, const int32_t *in_nbrs,
    const int32_t *seq_codes, const int32_t *bits_lut, int32_t *cols,
    int32_t *nm, int32_t *ctrl, int32_t *o_ids, int32_t *o_cell_send,
    int32_t *o_node_min, int32_t *o_node_end, int32_t *o_min, int Nm, int Cm,
    int B, int N, int K_in, int BP, int Lc, int P_fix, int LB, int smem,
    void *stream) {
  cudaError_t err = cudaFuncSetAttribute(
      slice_cells_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + LB - 1) / LB;
  slice_cells_kernel<WIDE><<<blocks, LB * 32, smem, (cudaStream_t)stream>>>(
      ids, proj_over, p_ids, p_node_min, p_node_end, p_cell_send, p_min,
      active, first_slice, seq_len, read_codes, win, node_len, node_start,
      in_nbrs, seq_codes, bits_lut, cols, nm, ctrl, o_ids, o_cell_send,
      o_node_min, o_node_end, o_min, Nm, Cm, B, N, K_in, BP, Lc, P_fix, LB);
  return (int)cudaGetLastError();
}

#define SLICE_CELLS_PARAMS                                                    \
  const int32_t *ids, const uint8_t *proj_over, const int32_t *p_ids,        \
      const int32_t *p_node_min, const int32_t *p_node_end,                   \
      const int32_t *p_cell_send, const int32_t *p_min,                       \
      const uint8_t *active, const uint8_t *first_slice,                      \
      const int32_t *seq_len, const uint8_t *read_codes, const int32_t *win,  \
      const int32_t *node_len, const int32_t *node_start,                     \
      const int32_t *in_nbrs, const int32_t *seq_codes,                       \
      const int32_t *bits_lut, int32_t *cols, int32_t *nm, int32_t *ctrl,     \
      int32_t *o_ids, int32_t *o_cell_send, int32_t *o_node_min,              \
      int32_t *o_node_end, int32_t *o_min, int Nm, int Cm, int B, int N,      \
      int K_in, int BP, int Lc, int P_fix, int LB, int smem, void *stream
#define SLICE_CELLS_ARGS                                                      \
  ids, proj_over, p_ids, p_node_min, p_node_end, p_cell_send, p_min, active, \
      first_slice, seq_len, read_codes, win, node_len, node_start, in_nbrs,   \
      seq_codes, bits_lut, cols, nm, ctrl, o_ids, o_cell_send, o_node_min,    \
      o_node_end, o_min, Nm, Cm, B, N, K_in, BP, Lc, P_fix, LB, smem, stream

// the narrow route: up to 5 in-neighbours, one pred word a slot
extern "C" int ga_slice_cells(SLICE_CELLS_PARAMS) {
  if (Nm < 1 || Nm > 32 || K_in < 1 || K_in > 5 || LB < 1 || LB > 32 ||
      Lc < 64)
    return (int)cudaErrorInvalidValue;
  return launch_slice_cells<false>(SLICE_CELLS_ARGS);
}

// the wide route: past 5 in-neighbours, ceil(K_in / 5) pred planes
extern "C" int ga_slice_cells_wide(SLICE_CELLS_PARAMS) {
  if (Nm < 1 || Nm > 32 || K_in < 6 || LB < 1 || LB > 32 ||
      Lc < 64)
    return (int)cudaErrorInvalidValue;
  return launch_slice_cells<true>(SLICE_CELLS_ARGS);
}
