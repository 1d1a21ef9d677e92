"""A variation graph as ``vg construct -m <max_node>`` builds it from a
reference and a VCF of small variants, the reference and the variants
drawn from the seed at the rates the configuration states.

The reference is ``ref_length`` bases drawn uniformly. Variant sites are
drawn at uniform positions, one per ``variant_spacing_bp`` on average;
each is a SNP (``snp_share``), an insertion (``ins_share``) or a deletion
(the rest), an indel's length geometric with ``indel_len_p`` up to
``indel_max`` bp. A site that would overlap the one before it, or touch it
with no reference base between, is dropped (``vg construct`` would merge
the two into one site). As ``vg construct`` builds the graph: a SNP is two
1-bp allele nodes, the reference base and the alternative, between the
reference nodes around it; a deletion keeps the deleted bases as the
reference allele's node(s) beside an edge over them; an insertion is an
allele node beside the direct edge. Every run of reference bases and every
allele is cut into nodes of ``max_node`` bp, the last shorter. Node ids
count up along the reference, each site's alleles after the segment
before it.

Handed to both sides as the digraph's arrays.
"""

from __future__ import annotations

import numpy as np

from .site_graph import SiteGraph

# "ACGT" index -> graph code (A=0, T=1, C=2, G=3); complement is code ^ 1
_DRAW_CODE = np.array([0, 2, 3, 1], dtype=np.uint8)
SNP, INS, DEL = 0, 1, 2


def _sites(graph: dict, L: int, rng):
    """(start, end, kind, indel length) of the kept sites, reference
    bases start:end the reference allele."""
    n = int(round(L / float(graph["variant_spacing_bp"])))
    start = np.sort(rng.integers(1, L - 1, n))
    u = rng.random(n)
    snp, ins = float(graph["snp_share"]), float(graph["ins_share"])
    kind = np.where(u < snp, SNP, np.where(u < snp + ins, INS, DEL))
    k = np.minimum(rng.geometric(float(graph["indel_len_p"]), n),
                   int(graph["indel_max"]))
    end = start + np.where(kind == SNP, 1, np.where(kind == INS, 0, k))
    idx = np.nonzero(end <= L - 1)[0]
    while True:
        # drop a site that meets the one before it, unless that one is
        # itself dropped in this pass: sequential keeping, pass by pass
        bad = np.zeros(len(idx), dtype=bool)
        bad[1:] = start[idx[1:]] < end[idx[:-1]] + 1
        first = bad & ~np.concatenate([[False], bad[:-1]])
        if not first.any():
            return start[idx], end[idx], kind[idx], k[idx]
        idx = idx[~first]


def _spread(off, lens):
    """Indices off[i] + 0 .. lens[i] - 1, back to back."""
    total = int(lens.sum())
    base = np.repeat(off - np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return base + np.arange(total)


def build(graph: dict, seed: int) -> SiteGraph:
    rng = np.random.default_rng(seed)
    L = int(graph["ref_length"])
    M = int(graph["max_node"])
    ref = rng.integers(0, 4, L, dtype=np.uint8)
    start, end, kind, k = _sites(graph, L, rng)
    n = len(start)
    alt_snp = (ref[start[kind == SNP]]
               + rng.integers(1, 4, int((kind == SNP).sum()))) % 4
    ins_len = k[kind == INS]
    ins_bases = rng.integers(0, 4, int(ins_len.sum()), dtype=np.uint8)
    # segments: the reference between sites
    seg_start = np.concatenate([[0], end])
    seg_len = np.concatenate([start, [L]]) - seg_start
    # alleles: two a site, the reference's first
    a0_len = end - start
    a1_len = np.where(kind == SNP, 1, np.where(kind == INS, k, 0))
    a1_src = np.zeros(n, dtype=np.int64)
    a1_src[kind == SNP] = L + np.arange(len(alt_snp))
    a1_src[kind == INS] = L + len(alt_snp) + np.concatenate(
        [[0], np.cumsum(ins_len)[:-1]])
    pool = np.concatenate([ref, alt_snp.astype(np.uint8), ins_bases])
    a_len = np.stack([a0_len, a1_len], 1).reshape(-1)
    a_src = np.stack([start, a1_src], 1).reshape(-1)
    allele_codes = pool[_spread(a_src, a_len)]
    allele_off = np.zeros(2 * n + 1, dtype=np.int64)
    np.cumsum(a_len, out=allele_off[1:])
    site_ptr = 2 * np.arange(n + 1, dtype=np.int64)
    # pieces in node id order: segment 0, site 0's alleles, segment 1, ...
    p_len = np.concatenate([np.stack([seg_len[:-1], a0_len, a1_len], 1)
                            .reshape(-1), seg_len[-1:]])
    p_src = np.concatenate([np.stack([seg_start[:-1], L + allele_off[:-1:2],
                                      L + allele_off[1::2]], 1).reshape(-1),
                            seg_start[-1:]])
    p_nodes = -(-p_len // M)
    p_first = 1 + np.concatenate([[0], np.cumsum(p_nodes)[:-1]])
    p_first[p_len == 0] = 0
    seg_node = p_first[0::3]
    allele_node = np.stack([p_first[1::3], p_first[2::3]], 1).reshape(-1)
    # nodes: lengths, and their codes back to back
    N = int(p_nodes.sum())
    piece = np.repeat(np.arange(len(p_len)), p_nodes)
    kth = np.arange(N) - np.repeat(p_first[p_nodes > 0] - 1, p_nodes[p_nodes > 0])
    lens = np.minimum(p_len[piece] - M * kth, M)
    codes = _DRAW_CODE[np.concatenate([ref, allele_codes])[
        _spread(p_src[p_len > 0], p_len[p_len > 0])]]
    # per node: forward codes, then reverse complement
    ns = np.concatenate([[0], np.cumsum(lens)[:-1]])
    node_of = np.repeat(np.arange(N), lens)
    b = np.arange(len(codes))
    out = np.empty(2 * len(codes), dtype=np.uint8)
    out[b + ns[node_of]] = codes
    out[3 * ns[node_of] + 2 * lens[node_of] - 1 - b] = codes ^ 1
    # vg edges: along each piece, then each site's alleles between the
    # segments around it (an empty allele the edge over the site)
    ids = np.arange(1, N + 1)
    chain = ids[:-1][piece[:-1] == piece[1:]]
    seg_last = p_first[0::3] + p_nodes[0::3] - 1
    src, dst = [chain], [chain + 1]
    for j in (1, 2):
        first, cnt = p_first[j::3], p_nodes[j::3]
        full = cnt > 0
        src += [seg_last[:-1][full], (first + cnt - 1)[full],
                seg_last[:-1][~full]]
        dst += [first[full], seg_node[1:][full], seg_node[1:][~full]]
    a, bb = np.concatenate(src), np.concatenate(dst)
    # each vg edge a -> b: digraph a*2 -> b*2, then b*2+1 -> a*2+1; the
    # digraph node index of bigraph id m is 2m - 1 (forward), 2m (reverse)
    e_from = np.stack([2 * a - 1, 2 * bb], 1).reshape(-1)
    e_to = np.stack([2 * bb - 1, 2 * a], 1).reshape(-1)
    node_ids = np.stack([2 * ids, 2 * ids + 1], 1).reshape(-1)
    handed = {"arrays": (node_ids, np.tile([False, True], N),
                         np.repeat(lens, 2), out, e_from, e_to)}
    seg_codes = ref[_spread(seg_start, seg_len)]
    seg_off = np.zeros(n + 2, dtype=np.int64)
    np.cumsum(seg_len, out=seg_off[1:])
    return SiteGraph(handed, seg_codes, seg_off, seg_node.astype(np.int64),
                     site_ptr, allele_codes.astype(np.uint8), allele_off,
                     allele_node.astype(np.int64), M,
                     float(graph["alt_share"]))
