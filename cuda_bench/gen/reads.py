"""Reads along random haplotype paths of a SiteGraph, drawn in bulk with
torch on the device the benchmark runs on, from a traffic mix's
parameters:

- ``read_len``: ``{"mean", "sd", "min", "max"}``, a normal length clipped
  to [min, max]; without ``mean``, uniform over [min, max].
- ``errors``: per base, a substitution (to one of the three other bases)
  with ``sub``, a deletion with ``del``, an insertion after it with
  ``ins``: a copy of the base where ``ins_base`` is ``"repeat"`` (a
  homopolymer grown by one), any of the four where it is ``"random"``.
- ``seed``: one seed a read, a node start of its path as the read meets
  it: ``"at"`` ``"uniform"`` (drawn among them) or ``"first"``;
  ``"strand"`` ``"both"`` (half the reads, drawn, are the reverse
  complement, seeded on the reverse strand) or ``"forward"``.

A read starts at a base drawn uniformly along the backbone, followed by
the longest read and 64 bp of backbone; at each site it takes the
reference allele, or with the graph's ``alt_share`` an alternative one,
drawn uniformly. Its seed is (node id, read position, reverse): the read's
position of the node's first base on the seed's strand.

Reads are drawn in batches of ``BATCH``, each from a generator of its own
seeded from (run seed, stream, batch number), so that the same seed gives
the same reads on one kind of device, and reads of different streams (the
pool, the warm-up) never coincide.
"""

from __future__ import annotations

import numpy as np
import torch

from .site_graph import SiteGraph

BATCH = 2048


def stream_seed(*words: int) -> int:
    """A 63-bit generator seed from any whole numbers."""
    state = np.random.SeedSequence([w % 2**64 for w in words]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


class ReadMaker:
    """Draws reads of one SiteGraph on ``device``."""

    def __init__(self, sg: SiteGraph, traffic: dict, device):
        self.dev = torch.device(device)
        rl = traffic["read_len"]
        self.lo, self.hi = int(rl["min"]), int(rl["max"])
        self.mean = rl.get("mean")
        self.sd = float(rl.get("sd", 0))
        err = traffic["errors"]
        self.sub, self.ins, self.dele = (float(err[k]) for k in
                                         ("sub", "ins", "del"))
        self.repeat = {"repeat": True, "random": False}[err["ins_base"]]
        seed = traffic["seed"]
        self.uniform = {"uniform": True, "first": False}[seed["at"]]
        self.both = {"both": True, "forward": False}[seed["strand"]]
        self.M = int(sg.max_node)
        self.alt = float(sg.alt_share)
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.dev)  # noqa: E731
        n = sg.n_segments
        self.codes = t(np.concatenate([sg.seg_codes, sg.allele_codes]))
        self.ascii = t(np.frombuffer(b"ACGT", dtype=np.uint8).copy())
        self.cum = t(sg.seg_off)
        self.seg_start = self.cum[:-1]
        self.seg_len = self.cum[1:] - self.cum[:-1]
        self.seg_node = t(sg.seg_node)
        aoff = t(sg.allele_off)
        self.allele_start = aoff[:-1] + len(sg.seg_codes)
        self.allele_len = aoff[1:] - aoff[:-1]
        self.allele_node = t(sg.allele_node)
        ptr = t(sg.site_ptr)
        self.site_first = ptr[:-1]
        self.site_count = ptr[1:] - ptr[:-1]
        self.n_seg = n
        # starts followed by the longest read and 64 bp of backbone
        self.n_starts = int(sg.seg_off[-1]) - self.hi - 64
        if self.n_starts < 1:
            raise ValueError("the graph's backbone is shorter than a read")

    def _lengths(self, n, g):
        dev = self.dev
        if self.mean is None:
            return torch.randint(self.lo, self.hi + 1, (n,), generator=g,
                                 device=dev)
        x = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
        L = torch.round(float(self.mean) + self.sd * x).long()
        return torch.clamp(L, self.lo, self.hi)

    def batch(self, n: int, seed: int):
        """(sequences [n] str, seeds [n] (node id, read position,
        reverse)) of n reads."""
        dev = self.dev
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        L = self._lengths(n, g)
        x = (torch.rand(n, generator=g, device=dev, dtype=torch.float64)
             * self.n_starts).long()
        s = torch.searchsorted(self.cum, x, right=True) - 1
        off = x - self.cum[s]
        # the last segment a read needs: its backbone alone covers it
        e = torch.searchsorted(self.cum, x + L) - 1
        P = 2 * (e - s + 1) - 1  # segments, and a site between each two
        r_of_p = torch.repeat_interleave(torch.arange(n, device=dev), P)
        p_off = torch.cumsum(P, 0) - P
        j = torch.arange(len(r_of_p), device=dev) - p_off[r_of_p]
        seg = s[r_of_p] + j // 2
        is_al = (j % 2) == 1
        site = torch.clamp(seg, max=self.n_seg - 2)
        u = torch.rand(len(j), generator=g, device=dev, dtype=torch.float64)
        alts = self.site_count[site] - 1
        pick = torch.where(
            u < self.alt,
            1 + torch.minimum((u / self.alt * alts).long(), alts - 1), 0)
        al = self.site_first[site] + pick
        p_start = torch.where(is_al, self.allele_start[al],
                              self.seg_start[seg])
        p_len = torch.where(is_al, self.allele_len[al], self.seg_len[seg])
        p_node = torch.where(is_al, self.allele_node[al], self.seg_node[seg])
        # each read's pieces from its first, in read-local bases
        p_cum = torch.cumsum(p_len, 0) - p_len
        p_loc = p_cum - p_cum[p_off][r_of_p] - off[r_of_p]
        # the pieces' bases, then each read's L of them from off
        p_of_b = torch.repeat_interleave(torch.arange(len(p_len), device=dev),
                                         p_len)
        loc = (torch.arange(len(p_of_b), device=dev) - p_cum[p_of_b]
               + p_loc[p_of_b])
        r_of_b = r_of_p[p_of_b]
        keep = (loc >= 0) & (loc < L[r_of_b])
        truth = self.codes[(p_start[p_of_b] + loc - p_loc[p_of_b])[keep]].long()
        # mutate
        T = len(truth)
        y = torch.rand(T, generator=g, device=dev, dtype=torch.float64)
        other = torch.randint(1, 4, (T,), generator=g, device=dev)
        ins_base = torch.randint(0, 4, (T,), generator=g, device=dev)
        is_sub = y < self.sub
        is_del = (y >= self.sub) & (y < self.sub + self.dele)
        is_ins = (y >= self.sub + self.dele) & (
            y < self.sub + self.dele + self.ins)
        base = torch.where(is_sub, (truth + other) % 4, truth)
        count = 1 - is_del.long() + is_ins.long()
        ends = torch.cumsum(count, 0)
        pos = ends - count
        out = torch.empty(int(ends[-1]), dtype=torch.uint8, device=dev)
        kept = ~is_del
        out[pos[kept]] = base[kept].to(torch.uint8)
        out[pos[is_ins] + 1] = (base if self.repeat else ins_base)[
            is_ins].to(torch.uint8)
        first = torch.cumsum(L, 0) - L  # each read's first truth base
        r_start = pos[first]
        M_r = torch.cat([r_start[1:], ends[-1:]]) - r_start
        # strands, and the reverse reads complemented end to end
        rev = (torch.rand(n, generator=g, device=dev) < 0.5) & self.both
        r_of_o = torch.repeat_interleave(torch.arange(n, device=dev), M_r)
        o = torch.arange(len(out), device=dev)
        flip = rev[r_of_o]
        src = torch.where(flip, 2 * r_start[r_of_o] + M_r[r_of_o] - 1 - o, o)
        text_codes = torch.where(flip, 3 - out[src], out[src])
        # node starts on the read's strand: (read, truth index, node id)
        M = self.M
        p_nodes = (p_len + M - 1) // M
        q = torch.repeat_interleave(torch.arange(len(p_len), device=dev),
                                    p_nodes)
        kth = torch.arange(len(q), device=dev) - (
            torch.cumsum(p_nodes, 0) - p_nodes)[q]
        r_of_q = r_of_p[q]
        fw_at = p_loc[q] + M * kth
        rv_at = p_loc[q] + torch.minimum(M * (kth + 1), p_len[q]) - 1
        at = torch.where(rev[r_of_q], rv_at, fw_at)
        inside = (at >= 0) & (at < L[r_of_q])
        r_of_q, at, node = r_of_q[inside], at[inside], (p_node[q] + kth)[inside]
        cnt = torch.bincount(r_of_q, minlength=n)
        if bool((cnt == 0).any()):
            raise ValueError("a read meets no node start")
        c_off = torch.cumsum(cnt, 0) - cnt
        v = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
        k = (torch.minimum((v * cnt).long(), cnt - 1) if self.uniform
             else torch.where(rev, cnt - 1, 0))
        pick = c_off + k
        t_node = pos[first + at[pick]] - r_start  # forward read position
        read_pos = torch.where(rev, M_r - 1 - t_node, t_node)
        read_pos = torch.clamp(read_pos, torch.zeros_like(M_r), M_r - 1)
        text = self.ascii[text_codes.long()].cpu().numpy().tobytes().decode(
            "ascii")
        bounds = [0] + torch.cumsum(M_r, 0).cpu().tolist()
        seqs = [text[bounds[i]:bounds[i + 1]] for i in range(n)]
        seeds = list(zip(node[pick].cpu().tolist(), read_pos.cpu().tolist(),
                         rev.cpu().tolist()))
        return seqs, seeds

    def reads(self, n: int, seed: int, stream: int, prefix: str):
        """n reads of a stream as (name, sequence, (node id, read
        position, reverse))."""
        out = []
        for k in range(0, n, BATCH):
            m = min(BATCH, n - k)
            seqs, seeds = self.batch(m, stream_seed(seed, stream, k // BATCH))
            out += [(f"{prefix}{k + i}", seqs[i], seeds[i]) for i in range(m)]
        return out
