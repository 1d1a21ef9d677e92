#!/usr/bin/env python3
"""Exhaustive-mode (-i) goldens for the torch port, made by the JAX package.

    JAX_PLATFORMS=cpu python tests/fixtures/torch/make_goldens.py [NAME ...]

The reference binary segfaults on every -i input, so the goldens of -i come
from ``graphaligner_tpu.runtime.aligner.align_reads`` (backend "jax", the
batched exhaustive engine) on the CPU. Each corpus writes
``tests/fixtures/torch/<NAME>/out.gam``. The longsim corpus runs
``BatchAligner.compute_tables`` with ``backend="column"``: the default
wavefront backend does not finish that graph on a CPU in minutes, and
``tests/test_engine.py`` holds the two backends bit-identical.

``biggraph_b35`` is a seeded corpus (``-b 35``) at ``bench_biggraph.py``'s
shape: the synthetic variation graph of ``tests/biggraph_util.py`` at
1,050,000 segments (about 2.6 M digraph nodes) and 100 reads of 10,048 bp,
aligned by ``align_reads_seeded_batch``. It writes ``reads.fastq``,
``seeds.gam``, ``out.gam`` (bigraph node ids, as the reference binary
writes them) and ``graph.sha256`` (the graph's checksum, from
``graphaligner_tpu_torch.graph.synthetic.graph_checksum``), and prints the
reads the JAX package sent to its host oracle. The graph is past 2,097,150
nodes, so the JAX package projects every band with its iterative
``pairwise`` mode; ``GA_REACH_MAXN`` is set to 0 so that it does not build
the reach table it would discard. It takes about 70 s.

``multiallelic`` is a seeded corpus on a graph of in-degree 8 (a
variation graph of short-tandem-repeat-like multi-allelic sites, from
``graphaligner_tpu_torch.graph.synthetic.make_multiallelic`` at
MA_SEGMENTS segments and numpy seed MA_SEED) with 100 reads of about 10 kb
along random allele paths, aligned by ``align_reads_seeded_batch`` at
``-b 35`` and at ``-b 5 -B 20``: it writes ``graph.gfa``,
``reads.fastq``, ``seeds.gam`` and ``out.gam`` into ``multiallelic_b35``
and ``multiallelic_b5_B20``, and prints the reads the JAX package sent to
its host oracle at each config. ``multiallelic_small`` writes the CPU
tests' corpus (MA_SMALL: 40 segments, 6 reads of 1,500 bp) and its two
goldens into ``multiallelic_small``. On the CPU the JAX package runs its XLA
cell pass and XLA walk there (past 5 in-neighbours). XLA's CPU fusion
emitters make that cell pass exponentially slow in the in-degree (one
fused loop body recomputes each merge's inputs), so this corpus runs with
``XLA_FLAGS=--xla_cpu_use_fusion_emitters=false``, which changes only how
XLA generates CPU code: the computation is integer and its results the
same.

``converging`` is a seeded corpus on a graph of in-degree past 32 (from
``graphaligner_tpu_torch.graph.synthetic.make_converging`` at CV_SEGMENTS
segments and numpy seed CV_SEED: multi-allelic sites, and about one gap in
ten a converging tree of 33 to 80 leaves, whose leaves all link into the
next segment) with CV_READS (20) reads of about 10 kb along random paths,
aligned by ``align_reads_seeded_batch`` at ``-b 35`` and ``-b 5 -B 20``:
it writes ``graph.gfa``, ``reads.fastq``, ``seeds.gam`` and ``out.gam``
into ``converging_b35`` and ``converging_b5_B20``, and prints the reads the
JAX package sent to its host oracle and the CPU time of each golden.
``converging_small`` writes the CPU tests' corpus (CV_SMALL: converging
trees of 33 to 70 leaves and one flat site of 33 short alleles) and its
two goldens into ``converging_small``. They run with the same XLA flag as
``multiallelic``.

``circular_i`` first writes its inputs (``write_circular``): the longsim
graph closed into a circle by one link from its sink node to its source
node (``graph.gfa``), and reads taken from one source-to-sink walk read as
a circle, half of them across the seam (``reads.fastq``). Its golden takes
the column backend's fixpoint on the CPU for about half an hour.
"""

from __future__ import annotations

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
FIX = os.path.join(ROOT, "tests", "fixtures")

# name -> (graph, reads, compute_tables backend)
CORPORA = {
    "smallexample_i": ("smallexample/sub_test.vg", "smallexample/read.fastq",
                       "wavefront"),
    "sim_i": ("sim/bubbles.vg", "sim/sim.fastq", "wavefront"),
    "longsim_i": ("longsim/graph.vg", "sim/sim.fastq", "column"),
    # a cyclic graph: the JAX engine takes its column backend's fixpoint
    "cyclic_i": ("sim/cyclic.gfa", "torch/cyclic_i/reads.fastq", "column"),
    # the longsim graph closed into a circle (a circular genome of ~51 kb a
    # strand): written by write_circular, then the column fixpoint
    "circular_i": ("torch/circular_i/graph.gfa",
                   "torch/circular_i/reads.fastq", "column"),
}

CIRCULAR_READS = 16  # half of them across the seam
CIRCULAR_LEN = 640  # 10 slices
CIRCULAR_SEED = 13


def write_circle_gfa(vg_file: str, gfa_file: str):
    """Writes the graph of ``vg_file`` (every edge + to +) as a GFA with one
    more link from each sink node to each source node, closing it into a
    circle. Returns (sequences by node id, out-neighbours by node id,
    sources, sinks)."""
    from graphaligner_tpu.io import stream, vg

    nodes, out = {}, {}
    for chunk in stream.read_messages(vg_file, vg.Graph):
        for n in chunk.node:
            nodes[n.id] = n.sequence
        for e in chunk.edge:
            if e.from_start or e.to_end:
                raise ValueError("write_circle_gfa expects + to + edges only")
            out.setdefault(e.from_, []).append(e.to)
    has_in = {t for ts in out.values() for t in ts}
    sources = sorted(n for n in nodes if n not in has_in)
    sinks = sorted(n for n in nodes if n not in out)
    with open(gfa_file, "w") as f:
        for n in sorted(nodes):
            f.write(f"S\t{n}\t{nodes[n]}\n")
        links = [(a, b) for a in sorted(out) for b in out[a]]
        links += [(a, b) for a in sinks for b in sources]
        for a, b in links:
            f.write(f"L\t{a}\t+\t{b}\t+\t0M\n")
    return nodes, out, sources, sinks


def write_circular(out_dir: str) -> None:
    """Writes ``graph.gfa`` and ``reads.fastq`` of the circular_i corpus.

    The graph: ``longsim/graph.vg`` (one source, one sink, node ids in
    topological order) closed by ``write_circle_gfa``. The reads:
    ``CIRCULAR_READS`` reads of ``CIRCULAR_LEN`` bp from one source-to-sink
    walk (each step takes one of the node's out-neighbours, sorted by id, at
    random) read as a circle; the first half start within
    ``CIRCULAR_LEN - 1`` bp of the walk's end, so they cross the seam; 5 %
    substitutions. All draws from one numpy generator seeded with
    ``CIRCULAR_SEED``."""
    import numpy as np

    nodes, out, (source,), (sink,) = write_circle_gfa(
        os.path.join(FIX, "longsim", "graph.vg"),
        os.path.join(out_dir, "graph.gfa"))
    rng = np.random.default_rng(CIRCULAR_SEED)
    walk = [source]
    while walk[-1] != sink:
        nxt = sorted(out[walk[-1]])
        walk.append(nxt[int(rng.integers(len(nxt)))])
    truth = "".join(nodes[n] for n in walk)
    L, R, half = len(truth), CIRCULAR_LEN, CIRCULAR_READS // 2
    starts = np.concatenate([
        rng.integers(L - R + 1, L, half),
        rng.integers(0, L - R + 1, CIRCULAR_READS - half),
    ])
    with open(os.path.join(out_dir, "reads.fastq"), "w") as f:
        for i, st in enumerate(starts):
            read = (truth + truth)[int(st):int(st) + R]
            mut = rng.random(R) < 0.05
            sub = rng.choice(list("ACGT"), R)
            seq = "".join(s if m else c for c, s, m in zip(read, sub, mut))
            f.write(f"@circ{i}\n{seq}\n+\n{'I' * R}\n")


BIG_SEGMENTS = 1_050_000
BIG_READS = 100
BIG_READ_LEN = 10_048


def run_jax_seeded(graph, aligner, reads, seeds):
    """The JAX package's ``align_reads_seeded_batch``: (the GAM records
    with bigraph node ids, as the reference binary writes them, in read
    order; the names of the reads it sent to its host oracle)."""
    from graphaligner_tpu.core import align as _align
    from graphaligner_tpu.core.batch_align import align_reads_seeded_batch
    from graphaligner_tpu.io import vg

    host = []
    orig = _align.get_split_alignment
    by_seq = {r.sequence: r.seq_id for r in reads}

    def split(graph_, sequence, *a, **kw):
        host.append(by_seq.get(sequence, "?"))
        return orig(graph_, sequence, *a, **kw)

    _align.get_split_alignment = split
    try:
        results = align_reads_seeded_batch(graph, aligner, reads, seeds)
    finally:
        _align.get_split_alignment = orig
    out = []
    for r in reads:
        res = results[r.seq_id]
        if res.alignment_failed or res.alignment.score == 2**31 - 1:
            continue
        a = vg.Alignment.decode(res.alignment.encode())
        for m in a.path.mapping:
            m.position.node_id //= 2
        out.append(a)
    return out, sorted(set(host))


def make_biggraph(out_dir: str, n_segments: int = BIG_SEGMENTS,
                  n_reads: int = BIG_READS) -> None:
    """The ``biggraph_b35`` corpus and its golden (see the module
    docstring). Prints the split of its time."""
    import time

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["GA_REACH_MAXN"] = "0"
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from biggraph_util import make_big_graph, make_reads

    from graphaligner_tpu.core.batch_align import BandedBatchAligner
    from graphaligner_tpu.core.engine_banded import build_graph_tables
    from graphaligner_tpu.io import load_fastq, stream, vg
    from graphaligner_tpu_torch.graph.synthetic import graph_checksum

    t0 = time.time()
    graph, backbone, seq = make_big_graph(n_segments)
    t_graph = time.time() - t0
    with open(os.path.join(out_dir, "graph.sha256"), "w") as f:
        f.write(graph_checksum(graph) + "\n")
    reads = make_reads(seq, n_reads, BIG_READ_LEN, graph, backbone)
    fq = os.path.join(out_dir, "reads.fastq")
    with open(fq, "w") as f:
        for name, s, _ in reads:
            f.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    stream.write_messages(os.path.join(out_dir, "seeds.gam"), [
        vg.Alignment(name=name, query_position=0, path=vg.Path(mapping=[
            vg.Mapping(position=vg.Position(node_id=node))]))
        for name, _, node in reads
    ])
    fastqs = load_fastq(fq)
    seed_map = {name: [(node, 0, False)] for name, _, node in reads}
    t0 = time.time()
    tables = build_graph_tables(graph)
    aligner = BandedBatchAligner(graph, 35, 0, _tables=tables)
    assert aligner._reach is None
    t_setup = time.time() - t0
    t0 = time.time()
    out, host = run_jax_seeded(graph, aligner, fastqs, seed_map)
    t_align = time.time() - t0
    stream.write_messages(os.path.join(out_dir, "out.gam"), out)
    print(f"biggraph_b35: {graph.node_count} digraph nodes, {len(out)}/"
          f"{len(fastqs)} aligned, host oracle for {host}; "
          f"graph {t_graph:.1f} s, tables and aligner {t_setup:.1f} s, "
          f"align {t_align:.1f} s", flush=True)


MA_SEGMENTS = 1000
MA_READS = 100
MA_READ_LEN = 10_000
MA_SEED = 17
MA_CONFIGS = {"multiallelic_b35": (35, 0), "multiallelic_b5_B20": (5, 20)}
# the small multi-allelic corpus of the CPU tests: 40 segments (k_in 8 at
# this seed), 6 reads of 1,500 bp, both configs' goldens in one directory
MA_SMALL = (40, 6, 1500, 3)
# XLA's CPU code generation without its fusion emitters (module docstring)
XLA_CPU_FLAG = "--xla_cpu_use_fusion_emitters=false"


def write_multiallelic(out_dir: str, n_segments=MA_SEGMENTS,
                       n_reads=MA_READS, read_len=MA_READ_LEN,
                       seed=MA_SEED) -> None:
    """The multiallelic corpus's inputs into ``out_dir``: graph.gfa,
    reads.fastq and seeds.gam (one forward seed a read, at its first
    segment, read position 0)."""
    sys.path.insert(0, ROOT)
    from graphaligner_tpu_torch.graph.synthetic import make_multiallelic
    from graphaligner_tpu_torch.io import stream, vg

    gfa, reads = make_multiallelic(n_segments, n_reads, read_len, seed)
    with open(os.path.join(out_dir, "graph.gfa"), "w") as f:
        f.write(gfa)
    with open(os.path.join(out_dir, "reads.fastq"), "w") as f:
        for name, s, _ in reads:
            f.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    stream.write_messages(os.path.join(out_dir, "seeds.gam"), [
        vg.Alignment(name=name, query_position=0, path=vg.Path(mapping=[
            vg.Mapping(position=vg.Position(node_id=node))]))
        for name, _, node in reads
    ])


def align_seeded_jax(in_dir: str, bw: int, ramp: int):
    """The JAX package's ``align_reads_seeded_batch`` over the corpus in
    ``in_dir`` (graph.gfa, reads.fastq, seeds.gam): (GAM records with
    bigraph node ids, as the reference binary writes them, in read order;
    the names of the reads it sent to its host oracle; the k_in of its
    graph tables)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from graphaligner_tpu.core.batch_align import BandedBatchAligner
    from graphaligner_tpu.graph.bigraph import graph_from_gfa_file
    from graphaligner_tpu.io import load_fastq
    from graphaligner_tpu.runtime.aligner import load_seed_hits

    graph = graph_from_gfa_file(os.path.join(in_dir, "graph.gfa"))
    reads = load_fastq(os.path.join(in_dir, "reads.fastq"))
    seeds = load_seed_hits(os.path.join(in_dir, "seeds.gam"),
                           [r.seq_id for r in reads])
    aligner = BandedBatchAligner(graph, bw, ramp)
    out, host = run_jax_seeded(graph, aligner, reads, seeds)
    return out, host, aligner.tables.k_in


def make_multiallelic_small() -> None:
    """``multiallelic_small/``: the inputs of MA_SMALL and the JAX
    package's goldens at both configs (out_b35.gam, out_b5_B20.gam)."""
    import time

    from graphaligner_tpu.io import stream

    out_dir = os.path.join(HERE, "multiallelic_small")
    os.makedirs(out_dir, exist_ok=True)
    write_multiallelic(out_dir, *MA_SMALL)
    for name, (bw, ramp) in MA_CONFIGS.items():
        t0 = time.time()
        out, host, k_in = align_seeded_jax(out_dir, bw, ramp)
        tag = name.split("_", 1)[1]
        stream.write_messages(os.path.join(out_dir, f"out_{tag}.gam"), out)
        print(f"multiallelic_small {tag}: k_in {k_in}, {len(out)}/"
              f"{MA_SMALL[1]} aligned, host oracle for {len(host)} reads; "
              f"align {time.time() - t0:.1f} s", flush=True)


def make_multiallelic() -> None:
    """Both multiallelic goldens (see the module docstring), with the CPU
    time each took."""
    import shutil
    import time

    from graphaligner_tpu.io import stream

    first = os.path.join(HERE, "multiallelic_b35")
    os.makedirs(first, exist_ok=True)
    write_multiallelic(first)
    for name, (bw, ramp) in MA_CONFIGS.items():
        out_dir = os.path.join(HERE, name)
        os.makedirs(out_dir, exist_ok=True)
        if out_dir != first:
            for f in ("graph.gfa", "reads.fastq", "seeds.gam"):
                shutil.copyfile(os.path.join(first, f),
                                os.path.join(out_dir, f))
        t0 = time.time()
        out, host, k_in = align_seeded_jax(out_dir, bw, ramp)
        stream.write_messages(os.path.join(out_dir, "out.gam"), out)
        print(f"{name}: k_in {k_in}, {len(out)}/{MA_READS} aligned, host "
              f"oracle for {len(host)} reads {host}; align "
              f"{time.time() - t0:.1f} s", flush=True)


CV_SEGMENTS = 1000
# cut from 100 reads: the JAX package's CPU run grows with the lanes, and
# at 100 it had not finished in two hours (fixtures README)
CV_READS = 20
CV_READ_LEN = 10_000
CV_SEED = 17
CV_CONFIGS = {"converging_b35": (35, 0), "converging_b5_B20": (5, 20)}


def write_converging(out_dir: str, n_segments=CV_SEGMENTS, n_reads=CV_READS,
                     read_len=CV_READ_LEN, seed=CV_SEED, **kw) -> dict:
    """The converging corpus's inputs into ``out_dir``: graph.gfa,
    reads.fastq and seeds.gam (one forward seed a read, at its first
    segment, read position 0). Returns the graph's k_in, node and link
    counts."""
    sys.path.insert(0, ROOT)
    from graphaligner_tpu_torch.graph.synthetic import make_converging
    from graphaligner_tpu_torch.io import stream, vg

    gfa, reads = make_converging(n_segments, n_reads, read_len, seed, **kw)
    with open(os.path.join(out_dir, "graph.gfa"), "w") as f:
        f.write(gfa)
    with open(os.path.join(out_dir, "reads.fastq"), "w") as f:
        for name, s, _ in reads:
            f.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    stream.write_messages(os.path.join(out_dir, "seeds.gam"), [
        vg.Alignment(name=name, query_position=0, path=vg.Path(mapping=[
            vg.Mapping(position=vg.Position(node_id=node))]))
        for name, _, node in reads
    ])
    lines = gfa.splitlines()
    return {"nodes": sum(ln[0] == "S" for ln in lines),
            "links": sum(ln[0] == "L" for ln in lines)}


def make_converging_goldens(out_dirs: dict, tag) -> None:
    """The JAX package's golden of each config in ``out_dirs`` (config ->
    (directory, GAM file name)), with the names of the reads it sent to its
    host oracle beside it (``<gam>_host.txt``, one a line), each beside
    its CPU time; every directory holds the same inputs."""
    import time

    from graphaligner_tpu.io import stream

    for name, (bw, ramp) in CV_CONFIGS.items():
        out_dir, gam = out_dirs[name]
        t0, c0 = time.time(), time.process_time()
        out, host, k_in = align_seeded_jax(out_dir, bw, ramp)
        stream.write_messages(os.path.join(out_dir, gam), out)
        with open(os.path.join(out_dir, gam[:-4] + "_host.txt"), "w") as f:
            f.write("".join(f"{n}\n" for n in host))
        print(f"{tag(name)}: k_in {k_in}, {len(out)} aligned, host oracle "
              f"for {len(host)} reads {host}; align {time.time() - t0:.1f} s"
              f" wall, {time.process_time() - c0:.1f} s CPU", flush=True)


# the converging corpus of the CPU tests: 18 segments, trees of 33 to 70
# leaves (the device lanes) and one flat site of 33 short alleles (the
# host oracle's lanes, as in both packages: its 34 band nodes pass 32), 5
# reads of 450 bp
CV_SMALL = dict(n_segments=18, n_reads=5, read_len=450, seed=2,
                sites=[("site", 3), ("site", 33), ("site", 2), ("tree", 40),
                       ("site", 2), ("tree", 70), ("site", 3), ("tree", 33),
                       ("site", 2), ("tree", 64), ("site", 4), ("tree", 50),
                       ("site", 2), ("tree", 35), ("site", 3), ("tree", 45),
                       ("site", 2)])


def make_converging_small() -> None:
    """``converging_small/``: the inputs of CV_SMALL and the JAX package's
    goldens at both configs (out_b35.gam, out_b5_B20.gam)."""
    out_dir = os.path.join(HERE, "converging_small")
    os.makedirs(out_dir, exist_ok=True)
    counts = write_converging(out_dir, **CV_SMALL)
    print(f"converging_small: {counts}", flush=True)
    make_converging_goldens(
        {n: (out_dir, f"out_{n.split('_', 1)[1]}.gam") for n in CV_CONFIGS},
        lambda n: f"converging_small {n.split('_', 1)[1]}")


def make_converging_corpus() -> None:
    """Both converging goldens (see the module docstring)."""
    import shutil

    first = os.path.join(HERE, "converging_b35")
    dirs = {}
    for name in CV_CONFIGS:
        out_dir = os.path.join(HERE, name)
        os.makedirs(out_dir, exist_ok=True)
        if out_dir == first:
            print(f"converging: {write_converging(first)}", flush=True)
        else:
            for f in ("graph.gfa", "reads.fastq", "seeds.gam"):
                shutil.copyfile(os.path.join(first, f),
                                os.path.join(out_dir, f))
        dirs[name] = (out_dir, "out.gam")
    make_converging_goldens(dirs, lambda n: n)


# the scan and walk units of tests/test_torch_in_degree_wide.py: the JAX
# package's banded_scan and walk_batch outputs at in-degree past 32, kept
# because its XLA cell pass and XLA walk take minutes to compile there
WIDE_DIR = os.path.join(HERE, "in_degree_wide")
WIDE_SCAN_K = (33, 64, 70)
WIDE_WALK_K = (33, 70)
WIDE_NM, WIDE_BW = 32, 35


def wide_scan_graph(K):
    """GFA text of a graph of in-degree K, two converging trees of K leaves
    (numpy seed K), with one back link from the segment their first tree
    joins (in-degree K) to that tree's first leaf, which closes a cycle;
    and (the joining segment's id, its in-neighbours' ids in order, their
    parents' ids)."""
    sys.path.insert(0, ROOT)
    from graphaligner_tpu_torch.graph.synthetic import make_converging

    gfa, _ = make_converging(4, 0, 0, K, sites=[("tree", K), ("site", 3),
                                                ("tree", K)])
    links = [tuple(int(x) for x in ln.split("\t")[1:4:2])
             for ln in gfa.splitlines() if ln.startswith("L")]
    into, parent = {}, {}
    for a, b in links:
        into.setdefault(b, []).append(a)
        parent.setdefault(b, a)
    join = min(n for n, src in into.items() if len(src) == K)
    leaves = into[join]
    gfa += f"L\t{join}\t+\t{leaves[0]}\t+\t0M\n"
    return gfa, join, leaves, [parent[x] for x in leaves]


def wide_scan_inputs(graph, tables, join, leaves, parents, K, B=8, S=3,
                     Cm=384):
    """banded_scan arguments from random carries around the joining
    segment: lane b's band holds one leaf (leaf 0, on the cycle, in lane
    0; past 32, and past 64 where there are, in others), its parent and
    sibling, the joining segment and what follows it, topo-rank sorted,
    with random scores and INF holes, random read codes, a lane short and
    lanes past their first slice (numpy seed K)."""
    import numpy as np

    rng = np.random.default_rng(K)
    EMPTY, INF = 2**31 - 1, 1 << 20
    N = tables.num_nodes
    rank = tables.topo_rank
    fwd = {int(graph.node_ids[n]) // 2: n for n in range(N)
           if graph.node_ids[n] % 2 == 0}
    picks = [0, K - 1, 32, int(rng.integers(32, K)), int(rng.integers(0, 32)),
             int(rng.integers(0, K)), int(rng.integers(32, K)),
             int(rng.integers(64, K)) if K > 64 else int(rng.integers(0, K))]
    ids = np.full((B, WIDE_NM), EMPTY, np.int32)
    for b, i in enumerate(picks[:B]):
        sib = [x for j, x in enumerate(leaves)
               if parents[j] == parents[i] and j != i][:1]
        nodes = {fwd[leaves[i]], fwd[parents[i]], fwd[join],
                 *(fwd[x] for x in sib)}
        nxt = [fwd[join] + 1, fwd[join] + 2, fwd[join] + 3]
        nodes |= {n for n in nxt if n in fwd.values()}
        nodes = sorted(nodes, key=lambda n: rank[n])[:WIDE_NM]
        ids[b, : len(nodes)] = nodes
    valid = ids < EMPTY
    lens = np.where(valid, tables.node_len[np.clip(ids, 0, N - 1)], 0)
    c_used = lens.sum(1)
    node_min = np.where(valid, rng.integers(0, 40, (B, WIDE_NM)), INF)
    node_min[rng.random((B, WIDE_NM)) < 0.15] = INF
    node_end = np.where(node_min < INF,
                        node_min + rng.integers(0, 6, (B, WIDE_NM)), INF)
    send = rng.integers(0, 50, (B, Cm))
    send[(np.arange(Cm)[None] >= c_used[:, None])
         | (rng.random((B, Cm)) < 0.1)] = INF
    init_min = np.where(valid & (node_min < INF), node_min, INF).min(1)
    codes = rng.integers(0, 4, (B, S * 64)).astype(np.uint8)
    steps = np.full(B, S, np.int32)
    steps[1] = S - 1
    start = rng.integers(0, 2, B).astype(np.int32)
    args = (codes, np.full(B, S * 64 + 128, np.int32), steps, start,
            np.full((S, B), WIDE_BW, np.int32), ids, send.astype(np.int32),
            node_min.astype(np.int32), node_end.astype(np.int32),
            init_min.astype(np.int32))
    return args, dict(S_max=S, Nm=WIDE_NM, Cm=Cm)


def jax_scan(gfa_file, args, shape):
    """The JAX package's banded_scan of ``args`` on ``gfa_file``, through
    its reach table where ensure_reach builds one, else its pairwise
    projection: (outputs as numpy arrays, whether it had a reach table,
    its k_in)."""
    import numpy as np

    import jax

    jax.config.update("jax_platforms", "cpu")
    from graphaligner_tpu.core.engine_banded import (
        banded_scan,
        build_graph_tables,
    )
    from graphaligner_tpu.core.reach import ensure_reach
    from graphaligner_tpu.graph.bigraph import graph_from_gfa_file

    tables = build_graph_tables(graph_from_gfa_file(gfa_file))
    reach = ensure_reach(tables, WIDE_BW + 63)
    out = banded_scan(*tables.device_args(), *args, **shape, _proj="reach",
                      reach=reach)
    return ({k: np.asarray(v) for k, v in out.items()}, reach is not None,
            tables.k_in)


def make_wide_scan(K: int) -> None:
    """``in_degree_wide/scan<K>.npz``: the graph, the scan arguments and
    the JAX package's outputs (``jax_<key>``), its k_in and whether it
    projected through a reach table."""
    import time

    import numpy as np

    from graphaligner_tpu_torch.core.tables import build_graph_tables
    from graphaligner_tpu_torch.graph import graph_from_gfa_file

    os.makedirs(WIDE_DIR, exist_ok=True)
    gfa, join, leaves, parents = wide_scan_graph(K)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g.gfa")
        with open(path, "w") as f:
            f.write(gfa)
        graph = graph_from_gfa_file(path)
        tables = build_graph_tables(graph)
        args, shape = wide_scan_inputs(graph, tables, join, leaves, parents,
                                       K)
        t0 = time.process_time()
        out, reach, k_in = jax_scan(path, args, shape)
    np.savez_compressed(
        os.path.join(WIDE_DIR, f"scan{K}.npz"), gfa=gfa, k_in=k_in,
        reach=reach, shape=np.array([shape["S_max"], shape["Nm"],
                                     shape["Cm"]]),
        **{f"a{i}": a for i, a in enumerate(args)},
        **{f"jax_{k}": v for k, v in out.items()})
    print(f"in_degree_wide scan{K}: k_in {k_in}, reach table {reach}; JAX "
          f"{time.process_time() - t0:.1f} s CPU", flush=True)


def make_wide_walk(K: int, n_reads: int = 16) -> None:
    """``in_degree_wide/walk<K>.npz``: a graph of 40 segments with a
    converging tree of K leaves in every other gap (numpy seed 100 + K),
    the walk of n_reads reads of 600 to 1,300 bp along it as the port's
    aligner hands it to K2 at -b 35 on the CPU (the arguments of its
    largest walk_moves call, cut to its lanes), and the JAX package's
    walk_batch traces and fail flags on the same tables at that call's
    budget (walk_batch's) and at one its longest lane cannot meet."""
    import time

    import numpy as np

    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from graphaligner_tpu.core.backtrace_device import walk_batch
    from graphaligner_tpu.core.engine_banded import build_graph_tables
    from graphaligner_tpu.graph.bigraph import graph_from_gfa_file
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.graph import graph_from_gfa_file as port_gfa
    from graphaligner_tpu_torch.graph.synthetic import make_converging
    from graphaligner_tpu_torch.io.fastq import FastQ

    os.makedirs(WIDE_DIR, exist_ok=True)
    gfa, reads = make_converging(
        40, n_reads, 1300, 100 + K, sites=[("tree", K), ("site", 3)] * 20)
    lens = [600 + 700 * i // (n_reads - 1) for i in range(n_reads)]
    fq = [FastQ(n, s[:L], "I" * L) for (n, s, _), L in zip(reads, lens)]
    seeds = {n: [(node, 0, False)] for n, _, node in reads}
    calls = []
    orig = ba.walk_moves

    def rec(*args, **kw):
        calls.append(([a.numpy().copy() for a in args], dict(kw)))
        return orig(*args, **kw)

    ba.walk_moves = rec
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "g.gfa")
        with open(path, "w") as f:
            f.write(gfa)
        graph = port_gfa(path)
        try:
            aligner = ba.BandedBatchAligner(graph, WIDE_BW, 0, "cpu")
            ba.align_reads_seeded_batch(graph, aligner, fq, seeds)
        finally:
            ba.walk_moves = orig
        args, kw = max(calls, key=lambda c: int((c[0][10][5] == 0).sum()))
        live = np.nonzero(args[10][5] == 0)[0]
        args = [a if i == 6 else np.ascontiguousarray(a[..., live])
                for i, a in enumerate(args)]
        cols, band, _, _, _, codes8, _, seq_len, seed, _, st = args
        K1, _, Cm, B = cols.shape
        node = band[st[0], st[2], np.arange(B)]
        w0 = (np.asarray(graph.node_start)[node] + st[3]).astype(np.int32)
        jcols = np.ascontiguousarray(
            cols[1:].transpose(1, 3, 0, 2).reshape(7, B, (K1 - 1) * Cm))
        jcodes = np.ascontiguousarray(
            codes8[1:].transpose(2, 0, 1).reshape(B, (K1 - 1) * 64))
        budgets = (kw["steps"], 64 * int(st[0].max()) - 1)
        jt = build_graph_tables(graph_from_gfa_file(path))
        res = {}
        t0 = time.process_time()
        for i, T in enumerate(budgets):
            trace, fail = walk_batch(jt, jcols, np.ascontiguousarray(band[1:]),
                                     jcodes, seq_len[0], seed[0], w0, st[0],
                                     T_max=int(T))
            res[f"jax_trace{i}"] = np.asarray(trace)
            res[f"jax_fail{i}"] = np.asarray(fail)
    np.savez_compressed(
        os.path.join(WIDE_DIR, f"walk{K}.npz"), gfa=gfa,
        k_in=aligner.tables.k_in, w0=w0, budgets=np.array(budgets),
        **{f"a{i}": a for i, a in enumerate(args)}, **res)
    print(f"in_degree_wide walk{K}: k_in {aligner.tables.k_in}, {B} lanes "
          f"of {len(calls)} K2 calls' largest, budgets {budgets}; JAX "
          f"{time.process_time() - t0:.1f} s CPU", flush=True)


def make(name: str, out_gam: str) -> list:
    """Aligns corpus ``name`` in -i mode with the JAX package and writes
    the concatenated GAM to ``out_gam``; returns the alignments."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from graphaligner_tpu.core import engine
    from graphaligner_tpu.core.params import AlignerParams
    from graphaligner_tpu.runtime.aligner import align_reads

    graph, reads, backend = CORPORA[name]
    params = AlignerParams(
        graph_file=os.path.join(FIX, graph),
        fastq_file=os.path.join(FIX, reads),
        alignment_file=out_gam,
        initial_bandwidth=35,
        initial_full_band=True,
    )
    orig = engine.BatchAligner.compute_tables

    def compute_tables(self, sequences, num_slices=None, backend_=None):
        return orig(self, sequences, num_slices, backend=backend)

    engine.BatchAligner.compute_tables = compute_tables
    try:
        with tempfile.TemporaryDirectory() as tmp:
            return align_reads(params, log=lambda *a: None, output_dir=tmp,
                               backend="jax")
    finally:
        engine.BatchAligner.compute_tables = orig


def main(names) -> int:
    import time

    names = names or sorted(CORPORA) + ["biggraph_b35", "multiallelic",
                                        "multiallelic_small", "converging",
                                        "converging_small", "in_degree_wide"]
    if any(n.startswith(("multiallelic", "converging", "in_degree_wide",
                         "scan", "walk")) for n in names):
        # before jax starts (module docstring)
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " " + XLA_CPU_FLAG).strip()
    for name in names:
        t0 = time.time()
        if name.startswith("multiallelic"):
            (make_multiallelic_small if name.endswith("small")
             else make_multiallelic)()
            print(f"{name}: {time.time() - t0:.1f} s", flush=True)
            continue
        if name.startswith(("scan", "walk")) and name[4:].isdigit():
            (make_wide_scan if name.startswith("scan")
             else make_wide_walk)(int(name[4:]))
            print(f"{name}: {time.time() - t0:.1f} s", flush=True)
            continue
        if name == "in_degree_wide":
            for K in WIDE_SCAN_K:
                make_wide_scan(K)
            for K in WIDE_WALK_K:
                make_wide_walk(K)
            print(f"{name}: {time.time() - t0:.1f} s", flush=True)
            continue
        if name.startswith("converging"):
            (make_converging_small if name.endswith("small")
             else make_converging_corpus)()
            print(f"{name}: {time.time() - t0:.1f} s", flush=True)
            continue
        out_dir = os.path.join(HERE, name)
        os.makedirs(out_dir, exist_ok=True)
        if name == "biggraph_b35":
            make_biggraph(out_dir)
            print(f"{name}: {time.time() - t0:.1f} s", flush=True)
            continue
        if name == "circular_i":
            write_circular(out_dir)
        alns = make(name, os.path.join(out_dir, "out.gam"))
        print(f"{name}: {len(alns)} alignments in {time.time() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
