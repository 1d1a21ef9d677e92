# Copy of graphaligner_tpu/tools/visualize_alignment.py for the torch port (imports point at graphaligner_tpu_torch).
"""ASCII rendering of a .trace file: graph row, match bars, read row,
node-id markers, char-wise and slice-wise HMM correctness tracks
(reference VisualizeAlignment.cpp). Usage: trace_file
"""

from __future__ import annotations

import sys

from ..core.hmm import CorrectnessState
from ..core.result import TraceItem, TraceMatchType


def load_trace(path: str):
    items = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 7:
                continue
            items.append(
                TraceItem(
                    node_id=int(parts[0]),
                    offset=int(parts[1]),
                    reverse=parts[2] == "1",
                    readpos=int(parts[3]),
                    type=TraceMatchType(int(parts[4])),
                    graph_char=parts[5],
                    read_char=parts[6],
                )
            )
    return items


def _pad(s: str, size: int) -> str:
    return s + " " * max(0, size - len(s))


def render(trace) -> str:
    graphinfo = ""
    graphpath = ""
    alignmentinfo = ""
    readinfo = ""
    readpath = ""
    slicewise_info = ""
    charwise = CorrectnessState()
    slicewise = CorrectnessState()
    charwise_correct_trace = []
    charwise_false_trace = []
    old_node = trace[0].node_id
    old_reverse = trace[0].reverse
    old_readpos = trace[0].readpos
    chars_until_check = 64
    mismatches = 0
    for i, item in enumerate(trace):
        if i == 0:
            graphinfo += "v"
            readinfo += "^"
        if (i > 0 and item.node_id != trace[i - 1].node_id) or (
            item.type == TraceMatchType.FORWARDBACKWARDSPLIT
        ):
            node_info = str(old_node) + ("-" if old_reverse else "+")
            if i > len(graphinfo) + len(node_info):
                graphinfo += node_info
            read_info = str(old_readpos)
            if i > len(readinfo) + len(read_info):
                readinfo += read_info
            graphinfo = _pad(graphinfo, i) + "v"
            readinfo = _pad(readinfo, i) + "^"
            old_node, old_reverse, old_readpos = item.node_id, item.reverse, item.readpos
        t = item.type
        if t == TraceMatchType.MATCH:
            graphpath += item.graph_char
            readpath += item.read_char
            alignmentinfo += "|"
            chars_until_check -= 1
        elif t == TraceMatchType.MISMATCH:
            graphpath += item.graph_char
            readpath += item.read_char
            alignmentinfo += " "
            mismatches += 1
            chars_until_check -= 1
        elif t == TraceMatchType.INSERTION:
            graphpath += " "
            readpath += item.read_char
            alignmentinfo += " "
            mismatches += 1
            chars_until_check -= 1
        elif t == TraceMatchType.DELETION:
            graphpath += item.graph_char
            readpath += " "
            mismatches += 1
            alignmentinfo += " "
        elif t == TraceMatchType.FORWARDBACKWARDSPLIT:
            graphpath += item.graph_char
            readpath += item.read_char
            alignmentinfo += "|" if item.graph_char == item.read_char else " "
        if chars_until_check == 0:
            slicewise = slicewise.next_state(min(mismatches, 64), 64)
            slicewise_info += ("#" if slicewise.currently_correct() else " ") * 64
            mismatches = 0
            chars_until_check = 64
        if t == TraceMatchType.MATCH:
            charwise = charwise.next_state(0, 1)
            charwise_correct_trace.append(charwise.correct_from_correct())
            charwise_false_trace.append(charwise.false_from_correct())
        elif t == TraceMatchType.FORWARDBACKWARDSPLIT:
            old_correct = charwise.currently_correct()
            charwise = CorrectnessState()
            charwise_correct_trace.append(old_correct)
            charwise_false_trace.append(old_correct)
            slicewise_info = _pad(slicewise_info, len(alignmentinfo))
            mismatches = 0
            chars_until_check = 64
            slicewise = CorrectnessState()
        else:
            charwise = charwise.next_state(1, 1)
            charwise_correct_trace.append(charwise.correct_from_correct())
            charwise_false_trace.append(charwise.false_from_correct())
    slicewise_info = _pad(slicewise_info, len(alignmentinfo))
    currently = charwise.currently_correct()
    charwise_info = []
    for i in range(len(charwise_correct_trace) - 1, -1, -1):
        if currently:
            charwise_info.append("#")
            currently = charwise_correct_trace[i]
        else:
            charwise_info.append(" ")
            currently = charwise_false_trace[i]
    charwise_info = "".join(reversed(charwise_info))
    return "\n".join(
        [
            "       " + graphinfo,
            "GRAPH: " + graphpath,
            "       " + alignmentinfo,
            "READ:  " + readpath,
            "       " + readinfo,
            "       " + charwise_info,
            "       " + slicewise_info,
        ]
    )


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    trace = load_trace(argv[0])
    if not trace:
        print("empty trace", file=sys.stderr)
        return 0
    print(render(trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
