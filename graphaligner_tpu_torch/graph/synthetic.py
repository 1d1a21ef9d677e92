# Port of tests/biggraph_util.py (make_big_graph, make_reads) for the torch port: the same draws, vectorised.
"""Synthetic pangenome-scale variation graph (chr20-class shapes: a linear
backbone with SNP bubbles) and reads sampled from it.

``make_big_graph`` gives the graph that ``tests/biggraph_util.py`` builds
from the same seed, node for node and edge for edge, without a Python loop
over segments: that generator draws one base at a time from one numpy
``Generator``, which hands out each 64-bit word as two 32-bit halves, low
half first, and a base is the top two bits of its half. The digraph is
built directly as arrays (``AlignmentGraph.from_arrays``), in the order
``graph.bigraph.graph_from_vg`` would add its nodes and edges.
"""

from __future__ import annotations

import numpy as np

from .alignment_graph import AlignmentGraph

BASES = np.array(list("ACGT"))
# "ACGT" draw -> graph code (A=0, T=1, C=2, G=3); complement is code ^ 1
_DRAW_CODE = np.array([0, 2, 3, 1], dtype=np.uint8)


def _draws(n_segments, seg_len, bubble_every, seed):
    """(segment draws [n, seg_len], bubble mask [n], alt draws [n_bub]),
    each draw an index into BASES."""
    i = np.arange(n_segments)
    bubble = (i % bubble_every == bubble_every - 1) & (i + 1 < n_segments)
    per = seg_len + bubble.astype(np.int64)
    total = int(per.sum())
    raw = np.random.default_rng(seed).bit_generator.random_raw(
        (total + 1) // 2)
    halves = np.stack([raw & 0xFFFFFFFF, raw >> 32], axis=1).reshape(-1)
    draws = (halves[:total] >> 30).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(per)[:-1]])
    return (draws[off[:, None] + np.arange(seg_len)], bubble,
            draws[off[bubble] + seg_len])


def make_big_graph(n_segments, seg_len=8, bubble_every=4, seed=11):
    """Backbone of n_segments nodes (seg_len bp) with a 1-bp SNP bubble
    node after every bubble_every-th segment, parallel to the next
    segment's start. Returns (AlignmentGraph, backbone node ids [n] int64,
    backbone sequence string). Bigraph nodes = n_segments + bubbles;
    digraph nodes = 2x that + the two dummy nodes."""
    seg, bubble, alt = _draws(n_segments, seg_len, bubble_every, seed)
    n = n_segments
    # bigraph ids: segments and their bubble nodes in creation order
    seg_id = 1 + np.arange(n) + np.concatenate(
        [[0], np.cumsum(bubble)[:-1]])
    alt_id = seg_id[bubble] + 1
    n_big = n + len(alt_id)
    lens = np.ones(n_big, dtype=np.int64)
    lens[seg_id - 1] = seg_len
    # per bigraph node (id order): forward codes, then reverse complement
    fw = np.zeros((n_big, seg_len), dtype=np.uint8)
    fw[seg_id - 1] = _DRAW_CODE[seg]
    fw[alt_id - 1, 0] = _DRAW_CODE[alt]
    rc = np.zeros_like(fw)
    rc[seg_id - 1] = fw[seg_id - 1, ::-1] ^ 1
    rc[alt_id - 1, 0] = fw[alt_id - 1, 0] ^ 1
    keep = np.arange(seg_len)[None, :] < lens[:, None]
    codes = np.stack([fw, rc], axis=1)[
        np.repeat(keep[:, None, :], 2, axis=1)]
    node_ids = np.stack([2 * np.arange(1, n_big + 1),
                         2 * np.arange(1, n_big + 1) + 1], 1).reshape(-1)
    reverse = np.tile([False, True], n_big)
    # vg edges in creation order: into segment i from its tails (the
    # previous segment, then its bubble node), then segment -> bubble node
    prev_bub = np.concatenate([[False], bubble[:-1]])
    tails_a = seg_id[:-1]
    into_a = seg_id[1:]
    into_b = seg_id[1:][prev_bub[1:]]
    src, dst, rank = [], [], []
    k = np.arange(1, n)  # segment index of each "into" edge
    src += [tails_a, alt_id, seg_id[bubble]]  # every bubble has a next
    dst += [into_a, into_b, alt_id]
    # ordering key: segment index, then 0 (from backbone), 1 (from the
    # bubble node), 2 (segment -> its bubble node)
    rank += [k * 3, k[prev_bub[1:]] * 3 + 1, np.nonzero(bubble)[0] * 3 + 2]
    src, dst, rank = (np.concatenate(a) for a in (src, dst, rank))
    order = np.argsort(rank, kind="stable")
    a, b = src[order], dst[order]
    # each vg edge a -> b: digraph a*2 -> b*2, then b*2+1 -> a*2+1; the
    # digraph node index of bigraph id m is 2m - 1 (forward), 2m (reverse)
    e_from = np.stack([2 * a - 1, 2 * b], 1).reshape(-1)
    e_to = np.stack([2 * b - 1, 2 * a], 1).reshape(-1)
    graph = AlignmentGraph.from_arrays(
        node_ids, reverse, np.repeat(lens, 2), codes, e_from, e_to)
    backbone_seq = "".join(BASES[seg.reshape(-1)])
    return graph, seg_id.astype(np.int64), backbone_seq


def graph_checksum(graph) -> str:
    """sha256 over a digraph's sequence codes, out-edges and node ids, as
    arrays of fixed dtypes (uint8, int64, int32, int64)."""
    import hashlib

    h = hashlib.sha256()
    for a, dt in ((graph.seq_codes, np.uint8), (graph.out_ptr, np.int64),
                  (graph.out_idx, np.int32), (graph.node_ids, np.int64)):
        h.update(np.ascontiguousarray(a, dtype=dt).tobytes())
    return h.hexdigest()


def make_reads(backbone_seq, n_reads, read_len, graph, backbone,
               seg_len=8, err=0.03, seed=5):
    """Reads sampled from the backbone with substitution errors, and the
    matching (name, sequence, seed node id) of each: the seed is the
    backbone node the read starts at, at read position 0, forward."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n_reads):
        start = int(rng.integers(0, len(backbone_seq) - read_len - 1))
        # snap to a segment boundary so the seed node/readpos pair is easy
        start -= start % seg_len
        sub = list(backbone_seq[start : start + read_len])
        n_err = int(err * read_len)
        for p in rng.integers(0, read_len, n_err):
            sub[p] = str(rng.choice(BASES))
        seed_node = int(backbone[start // seg_len])
        reads.append((f"bigread{i}", "".join(sub), seed_node))
    return reads


# allele counts of a multi-allelic site and their shares (ALLELE_COUNTS)
ALLELE_COUNTS = (2, 3, 4, 5, 6, 8)
ALLELE_SHARES = (0.60, 0.15, 0.10, 0.06, 0.05, 0.04)


def make_multiallelic(n_segments, n_reads, read_len, seed, seg_len=(32, 96),
                      max_allele=12, sub=0.03, indel=0.005,
                      counts=ALLELE_COUNTS, shares=ALLELE_SHARES):
    """A variation graph of short-tandem-repeat-like multi-allelic sites, as
    ``vg construct`` builds from a VCF with multi-allelic records, and reads
    along random allele paths through it.

    The backbone is n_segments random segments of seg_len bp (inclusive);
    between two consecutive segments sits a site of n alleles, n drawn from
    ``counts`` with ``shares`` (ALLELE_COUNTS, ALLELE_SHARES), the alleles
    distinct random sequences
    of 0 to max_allele bp, an empty one a direct edge between the segments.
    The segment after a site of n alleles has in-degree n (and so does the
    reverse strand of the segment before it). Node ids count up in path
    order: a segment, its site's alleles, the next segment.

    Each read starts at the first base of a random segment, follows a
    uniformly drawn allele at every site for read_len bp, and is mutated
    base by base: a substitution with probability ``sub``, a 1-bp deletion
    or insertion with ``indel / 2`` each. Everything is drawn from
    ``np.random.default_rng(seed)``.

    Returns (gfa text, reads), reads a list of (name, sequence, seed node
    id): the read's first segment, at read position 0, forward."""
    rng = np.random.default_rng(seed)

    def rand_seq(n):
        return "".join(BASES[rng.integers(0, 4, n)])

    seqs: list[str] = []
    links: list[tuple[int, int]] = []
    segs: list[int] = []
    sites: list[list[int]] = []  # per site, allele node ids (0: empty)
    for i in range(n_segments):
        seqs.append(rand_seq(int(rng.integers(seg_len[0], seg_len[1] + 1))))
        node = len(seqs)
        segs.append(node)
        if i:
            for a in sites[-1]:
                links.append((a or segs[-2], node))
        if i + 1 == n_segments:
            break
        n = int(rng.choice(counts, p=shares))
        alleles: list[str] = []
        while len(alleles) < n:
            s = rand_seq(int(rng.integers(0, max_allele + 1)))
            if s not in alleles:
                alleles.append(s)
        ids = []
        for s in alleles:
            if s:
                seqs.append(s)
                ids.append(len(seqs))
                links.append((node, len(seqs)))
            else:
                ids.append(0)
        sites.append(ids)
    gfa = "".join(f"S\t{i + 1}\t{s}\n" for i, s in enumerate(seqs))
    gfa += "".join(f"L\t{a}\t+\t{b}\t+\t0M\n" for a, b in links)

    seg_lens = np.array([len(seqs[s - 1]) for s in segs])
    rest = np.cumsum(seg_lens[::-1])[::-1]  # backbone bp from each segment
    starts = np.nonzero(rest >= read_len + 64)[0]
    reads = []
    for r in range(n_reads):
        first = int(rng.choice(starts))
        parts, length, i = [], 0, first
        while length < read_len:
            parts.append(seqs[segs[i] - 1])
            a = sites[i][int(rng.integers(0, len(sites[i])))] if i < len(
                sites) else 0
            if a:
                parts.append(seqs[a - 1])
            length += len(parts[-1]) + (len(parts[-2]) if a else 0)
            i += 1
        truth = "".join(parts)[:read_len]
        reads.append((f"ma{r}", _mutate(rng, truth, sub, indel),
                      segs[first]))
    return gfa, reads


# converging trees: their leaves, and the length of each branch node
TREE_LEAVES = (33, 80)
BRANCH_LEN = (40, 80)


def make_converging(n_segments, n_reads, read_len, seed, seg_len=(32, 96),
                    tree_share=0.1, leaves=TREE_LEAVES, branch_len=BRANCH_LEN,
                    max_allele=12, sub=0.03, indel=0.005, sites=None):
    """A variation graph where many paths converge on one node, as in a
    pangenome graph built from many haplotypes, and reads along random
    paths through it.

    The backbone is n_segments random segments of seg_len bp (inclusive).
    Between two consecutive segments sits either a multi-allelic site, as
    in ``make_multiallelic`` (n alleles drawn from ALLELE_COUNTS with
    ALLELE_SHARES, distinct random sequences of 0 to max_allele bp, an
    empty one a direct edge), or, with probability ``tree_share``, a
    converging tree: a binary tree of branch nodes of branch_len bp
    (inclusive), its root an out-neighbour of the segment before, each
    inner node with two out-neighbours, and its L leaves (L drawn from
    ``leaves``, inclusive) all linked into the segment after, which so has
    in-degree L while no tree node has out-degree above 2. ``sites``, if
    given, fixes the n_segments - 1 sites instead: ("site", n) or ("tree",
    L) each. Node ids count up in path order (a tree's nodes in preorder, its
    leaves left to right), and the links into a segment come in that
    order, so leaf i of a tree is the segment's in-neighbour i.

    Each read starts at the first base of a random segment and follows,
    for read_len bp, a uniformly drawn allele at every site and a
    uniformly drawn leaf's root-to-leaf path at every tree; it is mutated
    as in ``make_multiallelic``. Everything is drawn from
    ``np.random.default_rng(seed)``.

    Returns (gfa text, reads), reads a list of (name, sequence, seed node
    id): the read's first segment, at read position 0, forward."""
    rng = np.random.default_rng(seed)

    def rand_seq(n):
        return "".join(BASES[rng.integers(0, 4, n)])

    seqs: list[str] = []
    links: list[tuple[int, int]] = []
    segs: list[int] = []
    # per site, its paths to the next segment as node id lists ([] : an
    # empty allele)
    paths: list[list[list[int]]] = []

    def tree(L):
        """Adds a tree of L leaves (preorder ids); returns its root and
        its root-to-leaf paths, left to right."""
        seqs.append(rand_seq(int(rng.integers(branch_len[0],
                                              branch_len[1] + 1))))
        node = len(seqs)
        if L == 1:
            return node, [[node]]
        out = []
        for part in (L // 2, L - L // 2):
            child, sub_paths = tree(part)
            links.append((node, child))
            out += [[node] + p for p in sub_paths]
        return node, out

    for i in range(n_segments):
        seqs.append(rand_seq(int(rng.integers(seg_len[0], seg_len[1] + 1))))
        node = len(seqs)
        segs.append(node)
        if i:
            for p in paths[-1]:
                links.append((p[-1] if p else segs[-2], node))
        if i + 1 == n_segments:
            break
        if sites is not None:
            kind, n = sites[i]
        elif rng.random() < tree_share:
            kind, n = "tree", int(rng.integers(leaves[0], leaves[1] + 1))
        else:
            kind, n = "site", int(rng.choice(ALLELE_COUNTS, p=ALLELE_SHARES))
        if kind == "tree":
            root, site_paths = tree(n)
            links.append((node, root))
        else:
            alleles: list[str] = []
            while len(alleles) < n:
                s = rand_seq(int(rng.integers(0, max_allele + 1)))
                if s not in alleles:
                    alleles.append(s)
            site_paths = []
            for s in alleles:
                if s:
                    seqs.append(s)
                    links.append((node, len(seqs)))
                    site_paths.append([len(seqs)])
                else:
                    site_paths.append([])
        paths.append(site_paths)
    gfa = "".join(f"S\t{i + 1}\t{s}\n" for i, s in enumerate(seqs))
    gfa += "".join(f"L\t{a}\t+\t{b}\t+\t0M\n" for a, b in links)

    seg_lens = np.array([len(seqs[s - 1]) for s in segs])
    rest = np.cumsum(seg_lens[::-1])[::-1]  # backbone bp from each segment
    starts = np.nonzero(rest >= read_len + 64)[0]
    reads = []
    for r in range(n_reads):
        first = int(rng.choice(starts))
        parts, length, i = [], 0, first
        while length < read_len:
            parts.append(seqs[segs[i] - 1])
            if i < len(paths):
                p = paths[i][int(rng.integers(0, len(paths[i])))]
                parts += [seqs[n - 1] for n in p]
            length = sum(map(len, parts))
            i += 1
        truth = "".join(parts)[:read_len]
        reads.append((f"cv{r}", _mutate(rng, truth, sub, indel),
                      segs[first]))
    return gfa, reads


def _mutate(rng, truth, sub, indel):
    """``truth`` mutated base by base: a substitution with probability
    ``sub``, a 1-bp deletion or insertion with ``indel / 2`` each."""
    out = []
    for c in truth:
        x = rng.random()
        if x < sub:
            out.append(str(rng.choice([b for b in "ACGT" if b != c])))
        elif x < sub + indel / 2:
            continue
        else:
            out.append(c)
            if x < sub + indel:
                out.append(str(BASES[rng.integers(0, 4)]))
    return "".join(out)
