# Copy of graphaligner_tpu/tools/maf_to_alignment.py for the torch port (imports point at graphaligner_tpu_torch).
"""LAST/MAF simulated-read truth → GAM via a reference-path
position→node map (reference MafToAlignment.cpp).
Usage: graph.vg refpath.gam reads.maf out.gam out.fasta
"""

from __future__ import annotations

import sys

from ..io import vg
from ..io.sequences import reverse_complement
from ._common import load_alignments, load_vg_graph, node_sizes, write_alignments


def get_maf_entries(path: str):
    """Token-based parse matching the reference's stream extraction."""
    entries = []
    with open(path) as f:
        content = f.read()
    lines = content.split("\n")
    i = 0
    while i < len(lines):
        line = lines[i]
        if not line or line[0] != "a":
            i += 1
            continue
        # following tokens: s ref startpos length strand srcSize seq
        toks = []
        j = i + 1
        while j < len(lines) and len(toks) < 13:
            toks.extend(lines[j].split())
            j += 1
        if len(toks) < 13:
            break
        assert toks[0] == "s" and toks[1] == "ref"
        startpos, length = int(toks[2]), int(toks[3])
        seq = toks[6].replace("-", "")
        assert toks[7] == "s"
        readname = toks[8]
        direction = toks[11]
        if direction == "-":
            seq = reverse_complement(seq)
        entries.append(
            {
                "readname": readname,
                "realsequence": seq,
                "startpos": startpos,
                "length": length,
                "backward": direction == "-",
            }
        )
        i = j
    return entries


def mafs_to_alignments(mafs, pos_to_node, sizes, node_is_reverse):
    out = []
    for maf in mafs:
        node_ids = [pos_to_node[maf["startpos"]]]
        for j in range(1, maf["length"]):
            nid = pos_to_node[maf["startpos"] + j]
            if nid != node_ids[-1]:
                node_ids.append(nid)
        if maf["backward"]:
            node_ids.reverse()
        aln = vg.Alignment(name=maf["readname"], path=vg.Path())
        for j, nid in enumerate(node_ids):
            aln.path.mapping.append(
                vg.Mapping(
                    rank=j,
                    position=vg.Position(
                        node_id=nid,
                        is_reverse=node_is_reverse[nid] ^ maf["backward"],
                    ),
                    edit=[vg.Edit(from_length=sizes[nid])],
                )
            )
        out.append(aln)
    return out


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    graph = load_vg_graph(argv[0])
    ref_alignment = load_alignments(argv[1])[-1]
    pos_to_node = []
    node_is_reverse = {}
    for m in ref_alignment.path.mapping:
        size = m.edit[0].to_length
        pos_to_node.extend([m.position.node_id] * size)
        node_is_reverse[m.position.node_id] = m.position.is_reverse
    sizes = node_sizes(graph)
    mafs = get_maf_entries(argv[2])
    write_alignments(argv[3], mafs_to_alignments(mafs, pos_to_node, sizes, node_is_reverse))
    with open(argv[4], "w") as f:
        for maf in mafs:
            f.write(f">{maf['readname']}\n{maf['realsequence']}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
