# Copy of graphaligner_tpu/tools/bluntify.py for the torch port (imports point at graphaligner_tpu_torch).
"""Overlap (de Bruijn) GFA → blunt-ended GFA (reference Bluntify.cpp):
2-color nodes into KeepLeft/KeepRight/KeepAll by good/bad edge
propagation, then split each node into up to 3 pieces with rewired
edges. Usage: k in.gfa out.gfa
"""

from __future__ import annotations

import sys

KEEP_LEFT, KEEP_RIGHT, KEEP_ALL = 0, 1, 2


def load_pregraph(path: str):
    seqs: dict = {}
    edges = []
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\r\n")
            if not line:
                continue
            if line[0] == "S":
                parts = line.split("\t")
                seqs[int(parts[1])] = parts[2]
            elif line[0] == "L":
                parts = line.split("\t")
                edges.append(
                    (int(parts[1]), parts[2] == "-", int(parts[3]), parts[4] == "-")
                )
    n = max(seqs) + 1 if seqs else 0
    node_seqs = [""] * n
    for nid, s in seqs.items():
        node_seqs[nid] = s
    return node_seqs, edges


def get_keeping_types(node_seqs, edges):
    n = len(node_seqs)
    has_type = [False] * n
    result = [KEEP_LEFT] * n
    has_left = [False] * n
    has_right = [False] * n
    for frm, from_start, to, to_end in edges:
        if from_start:
            has_left[frm] = True
        else:
            has_right[frm] = True
        if to_end:
            has_right[to] = True
        else:
            has_left[to] = True
    for i in range(n):
        if not has_left[i] or not has_right[i]:
            result[i] = KEEP_ALL
            has_type[i] = True
    good = [set() for _ in range(n)]
    bad = [set() for _ in range(n)]
    for frm, from_start, to, to_end in edges:
        if from_start == to_end:
            good[frm].add(to)
            good[to].add(frm)
        else:
            bad[frm].add(to)
            bad[to].add(frm)
    for start in range(n):
        if has_type[start]:
            continue
        stack = [(start, KEEP_LEFT)]
        while stack:
            node, t = stack.pop()
            if has_type[node]:
                if result[node] != t:
                    result[node] = KEEP_ALL
                continue
            has_type[node] = True
            result[node] = t
            made_all = False
            for nb in good[node]:
                if has_type[nb] and result[nb] != KEEP_ALL and result[nb] != result[node]:
                    result[node] = KEEP_ALL
                    made_all = True
                    break
            if made_all:
                continue
            for nb in bad[node]:
                if has_type[nb] and result[nb] != KEEP_ALL and result[nb] == result[node]:
                    result[node] = KEEP_ALL
                    made_all = True
                    break
            if made_all:
                continue
            for nb in good[node]:
                if not has_type[nb]:
                    stack.append((nb, t))
            for nb in bad[node]:
                if not has_type[nb]:
                    stack.append((nb, KEEP_RIGHT if t == KEEP_LEFT else KEEP_LEFT))
    return result


def _new_index_and_direction(old_size, kmin1, old_id, old_end, old_off):
    if old_end and not old_off:
        return old_id * 3 + 1, True
    if not old_end and not old_off:
        return old_id * 3, False
    if old_end and old_off:
        return (old_id * 3 + 2, True) if old_size > 2 * kmin1 else (old_id * 3, True)
    return (
        (old_id * 3 + 2, False)
        if old_size > 2 * kmin1
        else (old_id * 3 + 1, False)
    )


def bluntify(node_seqs, edges, keeping, k):
    kmin1 = k - 1
    n = len(node_seqs)
    out_seqs = [""] * (n * 3)
    out_edges = []
    has_left = [False] * n
    has_right = [False] * n
    has_middle = [False] * n
    for i, seq in enumerate(node_seqs):
        size = len(seq)
        if size < 2 * kmin1:
            if keeping[i] in (KEEP_LEFT, KEEP_ALL):
                out_seqs[i * 3] = seq[: size - kmin1]
                has_left[i] = True
            if keeping[i] in (KEEP_RIGHT, KEEP_ALL):
                out_seqs[i * 3 + 1] = seq[kmin1:]
                has_right[i] = True
            if keeping[i] == KEEP_ALL:
                out_seqs[i * 3 + 2] = seq[size - kmin1 : size - kmin1 + 2 * kmin1 - size]
                has_middle[i] = True
        elif size == 2 * kmin1:
            if keeping[i] in (KEEP_LEFT, KEEP_ALL):
                out_seqs[i * 3] = seq[:kmin1]
                has_left[i] = True
            if keeping[i] in (KEEP_RIGHT, KEEP_ALL):
                out_seqs[i * 3 + 1] = seq[size - kmin1 :]
                has_right[i] = True
        else:
            if keeping[i] in (KEEP_LEFT, KEEP_ALL):
                out_seqs[i * 3] = seq[:kmin1]
                has_left[i] = True
            if keeping[i] in (KEEP_RIGHT, KEEP_ALL):
                out_seqs[i * 3 + 1] = seq[size - kmin1 :]
                has_right[i] = True
            out_seqs[i * 3 + 2] = seq[kmin1 : size - kmin1]
            has_middle[i] = True
        if has_left[i] and has_middle[i]:
            out_edges.append((i * 3, False, i * 3 + 2, False))
        if has_middle[i] and has_right[i]:
            out_edges.append((i * 3 + 2, False, i * 3 + 1, False))
        if size == 2 * kmin1 and has_left[i] and has_right[i]:
            out_edges.append((i * 3, False, i * 3 + 1, False))

    def has_part(idx, node):
        return (has_left, has_right, has_middle)[idx % 3][node]

    for off in (False, True):
        for frm, from_start, to, to_end in edges:
            nf, nf_dir = _new_index_and_direction(
                len(node_seqs[frm]), kmin1, frm, not from_start, off
            )
            nt, nt_dir = _new_index_and_direction(
                len(node_seqs[to]), kmin1, to, to_end, not off
            )
            if not has_part(nf, frm) or not has_part(nt, to):
                continue
            out_edges.append((nf, not nf_dir, nt, nt_dir))
    return out_seqs, out_edges


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    k = int(argv[0])
    node_seqs, edges = load_pregraph(argv[1])
    keeping = get_keeping_types(node_seqs, edges)
    counts = [keeping.count(t) for t in (KEEP_LEFT, KEEP_RIGHT, KEEP_ALL)]
    print(f"left: {counts[0]} right: {counts[1]} all: {counts[2]}", file=sys.stderr)
    out_seqs, out_edges = bluntify(node_seqs, edges, keeping, k)
    with open(argv[2], "w") as f:
        # start ids at 1 (0 is not a valid vg node id)
        for i, seq in enumerate(out_seqs):
            if seq:
                f.write(f"S\t{i + 1}\t{seq}\n")
        for frm, from_start, to, to_end in out_edges:
            f.write(
                f"L\t{frm + 1}\t{'-' if from_start else '+'}"
                f"\t{to + 1}\t{'-' if to_end else '+'}\t0M\n"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
