// Frozen copy of the banded slice DP of graphaligner_tpu_torch/native/ga_native.cpp
// (ga_compute_slice), part of the benchmark's plain reference: the closed row
// j-1 of a 64-row slice, then its 64 rows, each closed over the band's
// within-node chains and cross-edges. Built by native.py.

#include <cstdint>
#include <functional>
#include <queue>
#include <utility>
#include <vector>

static const int64_t GA_BIG = ((int64_t)1) << 40;

struct SliceClosure {
  int C;
  const uint8_t* chain;      // [C] 1 if cell c-1 -> c is a within-node edge
  const int64_t* edge_ptr;   // [C+1] CSR: cross-edges out of cell c
  const int32_t* edge_to;    // [edge_ptr[C]]
  std::vector<std::vector<int32_t>> buckets;
  int64_t sweeps = 0;        // sweep and fallback counts
  int64_t dial_calls = 0;
  int64_t heap_calls = 0;

  int n_edges_total = 0;
  const int32_t* edge_from_flat = nullptr;  // parallel to edge_to (flat)

  void run(int64_t* d) {
    // Fast path: forward chain sweeps + cross-edge relaxation to the
    // fixpoint. Band cross-edges (node-last -> successor-first) have
    // tiny depth (a handful of sweeps even on 200k-cell bands), and the
    // linear sweep is cache-friendly where the bucket queue thrashes.
    // Pathological cyclic bands fall back to the Dial queue.
    for (int iter = 0; iter < 80; iter++) {
      sweeps++;
      for (int c = 1; c < C; c++)
        if (chain[c] && d[c - 1] + 1 < d[c]) d[c] = d[c - 1] + 1;
      bool changed = false;
      for (int c = 0; c < C; c++) {
        for (int64_t e = edge_ptr[c]; e < edge_ptr[c + 1]; e++) {
          int t = edge_to[e];
          if (d[c] + 1 < d[t]) {
            d[t] = d[c] + 1;
            changed = true;
          }
        }
      }
      if (!changed) return;
    }
    run_dial(d);
  }

  // Heap Dijkstra fallback for pathological value spreads: identical
  // result to run_dial, no bucket-range assumption at all.
  void run_heap(int64_t* d) {
    heap_calls++;
    typedef std::pair<int64_t, int32_t> Ent;
    std::priority_queue<Ent, std::vector<Ent>, std::greater<Ent>> pq;
    for (int c = 0; c < C; c++)
      if (d[c] < GA_BIG) pq.push(Ent(d[c], c));
    while (!pq.empty()) {
      Ent top = pq.top();
      pq.pop();
      int c = top.second;
      if (top.first != d[c]) continue;  // stale entry
      int64_t nd = d[c] + 1;
      if (c + 1 < C && chain[c + 1] && nd < d[c + 1]) {
        d[c + 1] = nd;
        pq.push(Ent(nd, c + 1));
      }
      for (int64_t e = edge_ptr[c]; e < edge_ptr[c + 1]; e++) {
        int t = edge_to[e];
        if (nd < d[t]) {
          d[t] = nd;
          pq.push(Ent(nd, t));
        }
      }
    }
  }

  void run_dial(int64_t* d) {
    dial_calls++;
    int64_t dmin = GA_BIG, dmax = -GA_BIG;
    for (int c = 0; c < C; c++) {
      if (d[c] >= GA_BIG) continue;
      if (d[c] < dmin) dmin = d[c];
      if (d[c] > dmax) dmax = d[c];
    }
    if (dmin >= GA_BIG) return;
    // The bucket range must cover the full FINITE input spread (DP
    // scores routinely span more than C+1: band-source seeds at
    // seq_len+1 vs small old_end scores) PLUS the closure's growth
    // headroom: relaxation chains add +1 per step, so a cell reachable
    // only through a k-step chain from the nearest seed ends at
    // seed+k — up to dmax + C in the worst case. A bucket index beyond
    // the range would mean a relaxed cell never re-queues and its
    // successors silently keep stale values (caught by
    // test_native_slice_dial_and_heap_fallbacks's reversed-band
    // ladder). Absurd spreads take the heap.
    int64_t spread = dmax - dmin + 2 + (int64_t)C;
    if (spread > (int64_t)(1 << 22)) {
      run_heap(d);
      return;
    }
    int range = (int)spread;
    if ((int)buckets.size() < range) buckets.resize(range);
    for (int c = 0; c < C; c++) {
      int64_t off = d[c] - dmin;
      if (off < range) buckets[off].push_back(c);
    }
    for (int b = 0; b < range; b++) {
      auto& bk = buckets[b];
      for (size_t i = 0; i < bk.size(); i++) {
        int c = bk[i];
        if (d[c] != dmin + b) continue;  // stale entry
        int64_t nd = d[c] + 1;
        int64_t noff = nd - dmin;
        if (c + 1 < C && chain[c + 1] && nd < d[c + 1]) {
          d[c + 1] = nd;
          if (noff < range) buckets[noff].push_back(c + 1);
        }
        for (int64_t e = edge_ptr[c]; e < edge_ptr[c + 1]; e++) {
          int t = edge_to[e];
          if (nd < d[t]) {
            d[t] = nd;
            if (noff < range) buckets[noff].push_back(t);
          }
        }
      }
      bk.clear();
    }
  }
};

static int64_t ga_compute_slice_impl(
    int64_t C,
    const uint8_t* chain,        // [C]
    const int64_t* edge_ptr,     // [C+1]
    const int32_t* edge_to,      // cross-edges (node-last -> succ-first)
    int64_t n_sp,
    const int32_t* sp_cell,      // start-pred pairs
    const int32_t* sp_pred,
    int64_t n_ps,
    const int32_t* ps_cell,      // pseudo pairs
    const int64_t* ps_old,
    int64_t n_fs,
    const int32_t* fs_cell,      // free-start cells (slice 0 only)
    const uint8_t* match,        // [64 * C] row-major
    const int64_t* seed_sbs,     // [C] initial row j-1 values (GA_BIG absent)
    const int64_t* old_end,      // [C] previous slice last-row scores
    const uint8_t* old_flags,    // [C] bit0 = old_end_exists, bit1 = in_prev
    int64_t slice_index,
    int64_t* sbs,                // out [C] (closed row j-1)
    uint8_t* sbs_exists,         // out [C]
    int64_t* rows                // out [64 * C]
) {
  if (C <= 0) return 0;
  SliceClosure cl;
  cl.C = (int)C;
  cl.chain = chain;
  cl.edge_ptr = edge_ptr;
  cl.edge_to = edge_to;

  // row j-1 closure, then the existence stamping
  // (oracle.py: in_prev & (old_end == sbs) & old_end_exists)
  for (int64_t c = 0; c < C; c++) sbs[c] = seed_sbs[c];
  cl.run(sbs);
  for (int64_t c = 0; c < C; c++)
    sbs_exists[c] =
        ((old_flags[c] & 2) && sbs[c] == old_end[c] && (old_flags[c] & 1))
            ? 1
            : 0;

  const int64_t* prev = nullptr;
  for (int r = 0; r < 64; r++) {
    // compute directly into the output row (one less 1.6MB copy per
    // row on 200k-cell bands)
    int64_t* cur = rows + (size_t)r * C;
    const uint8_t* mrow = match + (size_t)r * C;
    const int64_t* diag = (r == 0) ? sbs : prev;
    // vertical
    for (int64_t c = 0; c < C; c++) {
      int64_t v = diag[c] + 1;
      // within-node diagonal
      if (chain[c]) {
        int64_t cost =
            (mrow[c] && (r > 0 || sbs_exists[c - 1])) ? 0 : 1;
        int64_t cand = diag[c - 1] + cost;
        if (cand < v) v = cand;
      }
      cur[c] = v;
    }
    // node-start diagonals from banded in-neighbors
    for (int64_t i = 0; i < n_sp; i++) {
      int32_t cell = sp_cell[i], p = sp_pred[i];
      int64_t cost = (mrow[cell] && (r > 0 || sbs_exists[p])) ? 0 : 1;
      int64_t cand = diag[p] + cost;
      if (cand < cur[cell]) cur[cell] = cand;
    }
    // pseudo columns from previous-band-only in-neighbors
    for (int64_t i = 0; i < n_ps; i++) {
      int32_t cell = ps_cell[i];
      int64_t cand = (r == 0) ? ps_old[i] + (mrow[cell] ? 0 : 1)
                              : ps_old[i] + r + 1;
      if (cand < cur[cell]) cur[cell] = cand;
    }
    // free-start diagonal at the very first slice
    if (r == 0 && slice_index == 0) {
      for (int64_t i = 0; i < n_fs; i++) {
        int32_t f = fs_cell[i];
        int64_t cand = sbs[f] + (mrow[f] ? 0 : 1);
        if (cand < cur[f]) cur[f] = cand;
      }
    }
    cl.run(cur);
    prev = cur;
  }
  return 1;
}

extern "C" int64_t cb_compute_slice(
    int64_t C, const uint8_t* chain, const int64_t* edge_ptr,
    const int32_t* edge_to, int64_t n_sp, const int32_t* sp_cell,
    const int32_t* sp_pred, int64_t n_ps, const int32_t* ps_cell,
    const int64_t* ps_old, int64_t n_fs, const int32_t* fs_cell,
    const uint8_t* match, const int64_t* seed_sbs, const int64_t* old_end,
    const uint8_t* old_flags, int64_t slice_index, int64_t* sbs,
    uint8_t* sbs_exists, int64_t* rows) {
  return ga_compute_slice_impl(
      C, chain, edge_ptr, edge_to, n_sp, sp_cell, sp_pred, n_ps, ps_cell,
      ps_old, n_fs, fs_cell, match, seed_sbs, old_end, old_flags,
      slice_index, sbs, sbs_exists, rows);
}
