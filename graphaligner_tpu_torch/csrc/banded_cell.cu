// Banded slice cell pass (kernel K1) for Hopper, sm_90a.
//
// Replaces graphaligner_tpu/ops/pallas/banded_cell.py::banded_cell_kernel:
// one 64-row slice, all Cm band cells in order for every lane — the
// within-node Myers advance, the fused boundary / pseudo / band-source
// column, the differenceMasks merge over the in-band predecessors read
// from the node-end buffer, the node-end buffer writes and the per-slot
// minimum of the last-row scores.
//
// Design: one thread per lane, looping serially over the cells with the
// column state in registers (uint64_t vp/vn, sbs, send, e). The TPU kernel
// read buf and nmin through one-hot masked sums because Mosaic has no
// dynamic gather; here they are indexed directly in global memory as
// [f, slot, lane], which neighbouring threads read and write coalesced
// since the batch is the last axis (and each lane only touches its own
// column, so L1 keeps it). Small blocks of 64 threads spread a chunk of a
// few thousand lanes over many SMs.
//
// What bounds it: the card's floor is the bytes — each input read once and
// each output written once is 7.49 MB at Cm=288, Nm=32, B=512, 2.2 us at
// 3.35 TB/s, against about 9.3 M int32 operations, 0.6 us at the int32
// issue rate — but the kernel takes about 0.26 ms there (NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py), a share below 0.01: the serial dependence
// along the cells (each cell needs the previous cell's column), with 16
// warps on 132 SMs at B=512, leaves it latency-bound. More lanes per SM,
// shared-memory staging of buf and fusing the per-slice metadata pass in
// are later work.
#include <cuda_runtime.h>

#include "wordops.cuh"

__global__ void banded_cell_kernel(
    const int32_t *__restrict__ meta1,   // [Cm, B]
    const int32_t *__restrict__ meta2,   // [Cm, B]
    const int32_t *__restrict__ old_end, // [Cm, B]
    const int32_t *__restrict__ pseudo,  // [Cm, B]
    const int32_t *__restrict__ eq_lo,   // [5, B]
    const int32_t *__restrict__ eq_hi,   // [5, B]
    const int32_t *__restrict__ seq_len, // [1, B]
    const int32_t *__restrict__ buf_init, // [7, Nm, B]
    int32_t *__restrict__ cols,          // [7, Cm, B]
    int32_t *__restrict__ buf,           // [7, Nm, B]
    int32_t *__restrict__ nmin,          // [Nm, B]
    int Cm, int Nm, int B, int K_in) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const size_t fN = (size_t)Nm * sB;  // field stride of buf
  const size_t fC = (size_t)Cm * sB;  // field stride of cols
  for (int f = 0; f < 7; ++f)
    for (int j = 0; j < Nm; ++j)
      buf[f * fN + j * sB + b] = buf_init[f * fN + j * sB + b];
  for (int j = 0; j < Nm; ++j) nmin[j * sB + b] = GA_INF;
  uint64_t eqw[5];
  for (int g = 0; g < 5; ++g) eqw[g] = ga_u64(eq_lo[g * sB + b], eq_hi[g * sB + b]);
  const int32_t slen = seq_len[b];

  Col col = {~0ull, 0ull, GA_INF, GA_INF + 64, 0};
  for (int c = 0; c < Cm; ++c) {
    const size_t at = (size_t)c * sB + b;
    const int32_t meta = meta1[at];
    const int slot = meta & 0xFF;
    const bool st = (meta >> 8) & 1;
    const bool en = (meta >> 9) & 1;
    const bool vc = (meta >> 10) & 1;
    const bool inprev = (meta >> 11) & 1;
    const int code = (meta >> 12) & 7;
    const bool srcnp = (meta >> 15) & 1;
    const bool srcsm = (meta >> 16) & 1;
    const int32_t oe = old_end[at];
    const int32_t ps = pseudo[at];
    const uint64_t eq = code < 5 ? eqw[code] : 0ull;

    // within-node chain advance
    const int32_t r_chain = min(oe, col.sbs + 1);
    uint64_t c_vp, c_vn;
    int32_t c_send;
    myers_advance((col.e & 1) ? eq : (eq & ~1ull), col.vp, col.vn, col.send,
                  r_chain - col.sbs, c_vp, c_vn, c_send);

    // fused uniform column (boundary / pseudo / band source)
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

    // in-band predecessor columns (getNodeStartSlice)
    const int32_t m2 = meta2[at];
    for (int k = 0; k < K_in; ++k) {
      const int pslot = (m2 >> (6 * k)) & 31;
      const bool pvalid = ((m2 >> (6 * k + 5)) & 1) && st;
      if (!pvalid) continue;
      int32_t g[7] = {0, 0, 0, 0, 0, 0, 0};
      if (pslot < Nm)
        for (int f = 0; f < 7; ++f) g[f] = buf[f * fN + pslot * sB + b];
      Col adv;
      int32_t a_send;
      myers_advance((g[6] & 1) ? eq : (eq & ~1ull), ga_u64(g[0], g[1]),
                    ga_u64(g[2], g[3]), g[5], 1, adv.vp, adv.vn, a_send);
      adv.sbs = g[4] + 1;
      adv.send = a_send;
      adv.e = g[6];
      merged = merge_slices(merged, adv);
    }

    Col n;
    if (!vc) {
      n.vp = ~0ull;
      n.vn = 0ull;
      n.sbs = GA_INF;
      n.send = GA_INF + 64;
    } else if (st) {
      n.vp = merged.vp;
      n.vn = merged.vn;
      n.sbs = merged.sbs;
      n.send = merged.send;
    } else {
      n.vp = c_vp;
      n.vn = c_vn;
      n.sbs = r_chain;
      n.send = c_send;
    }
    // field 6: bit0 = scoreBeforeExists, bits 1-3 = the cell's graph code
    n.e = ((inprev && n.sbs == oe && vc) ? 1 : 0) | (code << 1);

    const int32_t fields[7] = {
        (int32_t)(uint32_t)n.vp, (int32_t)(uint32_t)(n.vp >> 32),
        (int32_t)(uint32_t)n.vn, (int32_t)(uint32_t)(n.vn >> 32),
        n.sbs, n.send, n.e};
    for (int f = 0; f < 7; ++f) cols[f * fC + at] = fields[f];
    if (vc && slot < Nm) {
      if (en)
        for (int f = 0; f < 7; ++f) buf[f * fN + slot * sB + b] = fields[f];
      int32_t *nm = nmin + slot * sB + b;
      *nm = min(*nm, n.send);
    }
    col = n;
  }
}

extern "C" int ga_banded_cell(const int32_t *meta1, const int32_t *meta2,
                              const int32_t *old_end, const int32_t *pseudo,
                              const int32_t *eq_lo, const int32_t *eq_hi,
                              const int32_t *seq_len, const int32_t *buf_init,
                              int32_t *cols, int32_t *buf, int32_t *nmin,
                              int Cm, int Nm, int B, int K_in,
                              void *stream) {
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  banded_cell_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      meta1, meta2, old_end, pseudo, eq_lo, eq_hi, seq_len, buf_init, cols,
      buf, nmin, Cm, Nm, B, K_in);
  return (int)cudaGetLastError();
}
