# Copy of graphaligner_tpu/tools/simulate_reads.py for the torch port (imports point at graphaligner_tpu_torch).
"""Random-walk read simulator over a vg graph (reference
SimulateReads.cpp): bidirected traversal from a random start with
substitution / burst-insertion (<=20bp) / deletion errors; outputs truth
GAM, FASTQ, and a single-seed GAM per read.

Usage: graph.vg truth.gam reads.fastq numreads length sub ins seeds.gam del [seed]
"""

from __future__ import annotations

import random
import sys

from ..io import vg
from ..io.sequences import reverse_complement
from ._common import load_vg_graph, write_alignments


def introduce_errors(real, sub, ins, dele, rng):
    out = []
    for c in real:
        if rng.random() < dele:
            pass
        else:
            if rng.random() < sub:
                out.append(rng.choice("ATCG"))
            else:
                out.append(c)
        if rng.random() < ins / 10.0:
            out.extend(rng.choice("ATCG") for _ in range(rng.randrange(20)))
    return "".join(out)


def build_edges(graph):
    ids = {n.id: i for i, n in enumerate(graph.node)}
    out_right: dict = {}
    out_left: dict = {}
    for e in graph.edge:
        if e.from_start:
            out_left.setdefault(ids[e.from_], []).append((ids[e.to], e.to_end))
        else:
            out_right.setdefault(ids[e.from_], []).append((ids[e.to], e.to_end))
        if e.to_end:
            out_right.setdefault(ids[e.to], []).append((ids[e.from_], not e.from_start))
        else:
            out_left.setdefault(ids[e.to], []).append((ids[e.from_], not e.from_start))
    return out_right, out_left


def simulate_one_read(graph, length, sub, ins, dele, out_right, out_left, rng, depth=0):
    if depth > 500:
        raise RuntimeError("graph too small / too many dead ends for this length")
    reverse = rng.random() < 0.5
    real_nodes = []
    current = rng.randrange(len(graph.node))
    start_node = graph.node[current].id
    start_pos = rng.randrange(len(graph.node[current].sequence))
    if reverse:
        seq = reverse_complement(graph.node[current].sequence[:start_pos])
    else:
        seq = graph.node[current].sequence[start_pos:]
    while len(seq) < length:
        real_nodes.append((graph.node[current].id, reverse))
        edges = (out_left if reverse else out_right).get(current)
        if not edges:
            return simulate_one_read(
                graph, length, sub, ins, dele, out_right, out_left, rng, depth + 1
            )
        current, reverse = rng.choice(edges)
        if reverse:
            seq += reverse_complement(graph.node[current].sequence)
        else:
            seq += graph.node[current].sequence
    real_nodes.append((graph.node[current].id, reverse))
    seq = seq[:length]
    err_seq = introduce_errors(seq, sub, ins, dele, rng)

    name = f"read_{rng.randrange(2**31)}"
    truth = vg.Alignment(name=name, sequence=seq, path=vg.Path())
    for i, (node_id, rev) in enumerate(real_nodes):
        pos = vg.Position(node_id=node_id, is_reverse=rev)
        if i == 0:
            pos.offset = start_pos
        truth.path.mapping.append(vg.Mapping(position=pos))
    seed = vg.Alignment(
        name=name,
        query_position=1,
        path=vg.Path(mapping=[vg.Mapping(position=vg.Position(node_id=start_node))]),
    )
    return truth, err_seq, seed


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    graph = load_vg_graph(argv[0])
    num_reads, length = int(argv[3]), int(argv[4])
    sub, ins, dele = float(argv[5]), float(argv[6]), float(argv[8])
    rng = random.Random(int(argv[9]) if len(argv) > 9 else None)
    out_right, out_left = build_edges(graph)
    truths, seeds = [], []
    with open(argv[2], "w") as fq:
        for _ in range(num_reads):
            truth, err_seq, seed = simulate_one_read(
                graph, length, sub, ins, dele, out_right, out_left, rng
            )
            truths.append(truth)
            seeds.append(seed)
            fq.write(f"@{truth.name}\n{err_seq}\n+\n{'!' * len(err_seq)}\n")
    write_alignments(argv[1], truths)
    write_alignments(argv[7], seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
