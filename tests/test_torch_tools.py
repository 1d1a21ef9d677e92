"""The port's ecosystem tools and utils (tests/test_tools.py's 17 tests,
and tests/test_parallel.py's utils tests, on ``graphaligner_tpu_torch``).

- compare_alignments, visualize_alignment, bluntify and pick_seed_hits
  against the reference binaries' goldens under tests/fixtures/;
- every other tool, whose reference output was never captured, against
  the JAX tool's output bytes (files, stdout and stderr) on the same
  input, besides test_tools.py's own checks;
- simulate_reads -> the port's ``align_one_way_seeded`` ->
  compare_alignments;
- BufferedWriter;
- every tools and utils module imports, and compare_alignments runs, in a
  process where ``import jax`` and ``import graphaligner_tpu`` fail.
"""

import importlib
import pathlib
import pkgutil
import subprocess
import sys

import pytest

from graphaligner_tpu_torch.io import stream, vg
from graphaligner_tpu_torch.io.fastq import load_fastq
from graphaligner_tpu_torch.tools import (
    bluntify,
    compare_alignments,
    extract_path_sequence,
    pick_seed_hits,
    visualize_alignment,
)
from test_torch_runtime import BLOCK_JAX, NO_JAX_LOADED

FIX = pathlib.Path(__file__).parent / "fixtures"
ROOT = pathlib.Path(__file__).resolve().parents[1]
SIM = FIX / "sim"
GOLDEN = FIX / "golden"


def _same_as_jax(capsys, tmp_path, tool, argv):
    """Run the JAX tool and the port's on the same inputs, ``{out}`` in
    argv naming a file in each run's own directory; both must return the
    same code and write the same bytes. Returns the port's directory."""
    runs = []
    for pkg in ("graphaligner_tpu", "graphaligner_tpu_torch"):
        out = tmp_path / pkg
        out.mkdir()
        mod = importlib.import_module(f"{pkg}.tools.{tool}")
        rc = mod.main([a.format(out=out) for a in argv])
        printed = capsys.readouterr()
        files = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
        runs.append((rc, printed.out, printed.err.replace(str(out), "{out}"),
                     files))
    assert runs[1] == runs[0]
    assert runs[1][3] or runs[1][1]  # something was written
    return tmp_path / "graphaligner_tpu_torch"


def test_compare_alignments_matches_reference(capsys):
    compare_alignments.main(
        [str(SIM / "truth.gam"), str(SIM / "golden_b35" / "out.gam"),
         str(SIM / "bubbles.vg")]
    )
    out = capsys.readouterr().out
    assert out == (SIM / "compare_golden.txt").read_text()


def test_visualize_alignment_matches_reference(capsys):
    visualize_alignment.main([str(GOLDEN / "trace_0_read1.trace")])
    out = capsys.readouterr().out
    golden = (GOLDEN / "visualize_golden.txt").read_text()
    assert out.rstrip("\n").split("\n") == golden.rstrip("\n").split("\n")


@pytest.mark.parametrize("k, graph, golden", [
    ("4", "overlap.gfa", "bluntify_golden.gfa"),
    ("64", "overlap_unitigs.gfa", "bluntify_unitigs_golden.gfa"),
], ids=["overlap", "unitig_chain"])
def test_bluntify_matches_reference(tmp_path, k, graph, golden):
    out = tmp_path / "blunt.gfa"
    bluntify.main([k, str(SIM / graph), str(out)])
    want = (SIM / golden).read_text().strip().split("\n")
    assert sorted(out.read_text().strip().split("\n")) == sorted(want)


def _seed(name, pos, node):
    return vg.Alignment(name=name, query_position=pos, path=vg.Path(
        mapping=[vg.Mapping(position=vg.Position(node_id=node))]))


def test_pick_seed_hits(tmp_path, capsys):
    src = tmp_path / "in.gam"
    stream.write_messages(str(src), [
        _seed("r1", 5, 10), _seed("r1", 5, 10), _seed("r1", 9, 11),
        _seed("r1", 3, 12), _seed("r2", 0, 1),
    ])
    out = _same_as_jax(capsys, tmp_path, "pick_seed_hits",
                       ["{out}/out.gam", "2", str(src)])
    result = stream.read_messages(str(out / "out.gam"), vg.Alignment)
    assert len(result) == 2  # capped at 2, dup and node 1 dropped
    assert all(a.name == "r1" for a in result)


def test_pick_seed_hits_matches_reference_binary(tmp_path):
    out = tmp_path / "o.gam"
    pick_seed_hits.main([str(out), "2", str(SIM / "seeds.gam")])
    assert out.read_bytes() == (SIM / "pick_seeds_golden_cap2.gam").read_bytes()
    pick_seed_hits.main(
        [str(out), "1", str(SIM / "seeds.gam"), str(SIM / "seeds_rc.gam")]
    )
    assert out.read_bytes() == (
        SIM / "pick_seeds_golden_cap1_multi.gam"
    ).read_bytes()


def test_reverse_reads(tmp_path, capsys):
    src = tmp_path / "in.fastq"
    src.write_text("@r1\nACGTT\n+\n!!!#!\n@r2\nGGCA\n+\n#!!!\n")
    out = _same_as_jax(capsys, tmp_path, "reverse_reads",
                       [str(src), "{out}/out.fastq"])
    reads = load_fastq(str(out / "out.fastq"))
    assert reads[0].sequence == "AACGT"
    assert reads[0].quality == "!#!!!"


def test_alignment_sequence_inserter(tmp_path, capsys):
    src = tmp_path / "in.fastq"
    src.write_text("@r1\nACGTT\n+\n!!!!!\n")
    gam = tmp_path / "in.gam"
    stream.write_messages(str(gam), [vg.Alignment(name="r1")])
    out = _same_as_jax(capsys, tmp_path, "alignment_sequence_inserter",
                       [str(src), str(gam), "{out}/out.gam"])
    result = stream.read_messages(str(out / "out.gam"), vg.Alignment)
    assert result[0].sequence == "ACGTT"


def test_merge_graphs(tmp_path, capsys):
    g1 = tmp_path / "a.vg"
    g2 = tmp_path / "b.vg"
    stream.write_messages(str(g1), [vg.Graph(node=[vg.Node(id=1, sequence="AC")])])
    stream.write_messages(str(g2), [vg.Graph(node=[vg.Node(id=2, sequence="GT")],
                                             edge=[vg.Edge(from_=1, to=2)])])
    out = _same_as_jax(capsys, tmp_path, "merge_graphs",
                       [str(g1), str(g2), "-o", "{out}/merged.vg"])
    merged = stream.read_messages(str(out / "merged.vg"), vg.Graph)[0]
    assert {n.id for n in merged.node} == {1, 2}
    assert len(merged.edge) == 1


def test_merge_gfas(tmp_path, capsys):
    a = tmp_path / "a.gfa"
    b = tmp_path / "b.gfa"
    a.write_text("S\t1\tAC\nS\t2\tGT\nL\t1\t+\t2\t+\t0M\n")
    b.write_text("S\t3\tTT\nL\t2\t+\t3\t+\t0M\n")
    out = _same_as_jax(capsys, tmp_path, "merge_gfas",
                       ["{out}/m.gfa", str(a), str(b)])
    from graphaligner_tpu_torch.io.gfa import GfaGraph

    assert set(GfaGraph.load(str(out / "m.gfa")).nodes) == {1, 2, 3}


def test_extract_path_sequence(tmp_path, capsys):
    argv = [str(SIM / "bubbles.vg"), str(SIM / "truth.gam")]
    _same_as_jax(capsys, tmp_path, "extract_path_sequence", argv)
    extract_path_sequence.main(argv)
    lines = capsys.readouterr().out.split("\n")
    assert lines[0].startswith(">read_")
    names = {line[1:] for line in lines if line.startswith(">")}
    for t in stream.read_messages(str(SIM / "truth.gam"), vg.Alignment):
        assert t.name in names


def test_simulate_reads_and_compare_pipeline(tmp_path, capsys):
    """simulate -> align -> compare with the port's own tools and its
    per-read host path; the simulated files equal the JAX tool's."""
    argv = [str(SIM / "bubbles.vg"), "{out}/truth.gam", "{out}/reads.fastq",
            "3", "300", "0.02", "0.02", "{out}/seeds.gam", "0.02", "7"]
    out = _same_as_jax(capsys, tmp_path, "simulate_reads", argv)
    fastqs = load_fastq(str(out / "reads.fastq"))
    assert len(fastqs) == 3
    truths = stream.read_messages(str(out / "truth.gam"), vg.Alignment)
    assert all(len(t.path.mapping) >= 1 for t in truths)
    assert all(len(t.sequence) == 300 for t in truths)
    from graphaligner_tpu_torch.core.align import align_one_way_seeded
    from graphaligner_tpu_torch.graph import load_alignment_graph
    from graphaligner_tpu_torch.runtime.aligner import replace_digraph_node_ids

    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    seed_list = stream.read_messages(str(out / "seeds.gam"), vg.Alignment)
    pred = []
    for read, seed in zip(fastqs, seed_list):
        res = align_one_way_seeded(
            graph, read.seq_id, read.sequence, 35, 0,
            [(seed.path.mapping[0].position.node_id, seed.query_position,
              seed.path.mapping[0].position.is_reverse)],
        )
        if not res.alignment_failed:
            replace_digraph_node_ids(res.alignment)
            pred.append(res.alignment)
    sizes = compare_alignments.node_sizes(
        compare_alignments.load_vg_graph(str(SIM / "bubbles.vg"))
    )
    # SimulateReads emits forward-orientation seeds only, so the
    # reverse-strand truths may misalign; the forward ones must be good
    ident = [
        compare_alignments.identity_percent(
            compare_alignments.alignment_identity(t, p, sizes)
        )
        for t, p in zip(truths, pred)
        if t.name == p.name and not t.path.mapping[0].position.is_reverse
    ]
    assert ident and all(i >= 0.7 for i in ident)


def test_extract_path_subgraph_neighbourhood(tmp_path, capsys):
    gfa = tmp_path / "g.gfa"
    gfa.write_text(
        "S\t1\tACGTACGT\nS\t2\tGGGG\nS\t3\tTTTT\n"
        "L\t1\t+\t2\t+\t0M\nL\t2\t+\t3\t+\t0M\n"
    )
    gam = tmp_path / "a.gam"
    # NodePos keys its side by is_reverse (a reference quirk), so the walk
    # follows the '+' edges only when is_reverse is set here
    stream.write_messages(
        str(gam),
        [vg.Alignment(name="x", path=vg.Path(
            mapping=[vg.Mapping(position=vg.Position(node_id=1, is_reverse=True))]))],
    )
    out = _same_as_jax(capsys, tmp_path, "extract_path_subgraph_neighbourhood",
                       [str(gfa), "{out}/sub.gfa", str(gam), "10"])
    from graphaligner_tpu_torch.io.gfa import GfaGraph

    sub = GfaGraph.load(str(out / "sub.gfa"))
    assert 1 in sub.nodes and 2 in sub.nodes


def test_alignment_overlap(tmp_path, capsys):
    graph = tmp_path / "g.vg"
    stream.write_messages(str(graph), [vg.Graph(node=[
        vg.Node(id=i, sequence="A" * 10) for i in range(1, 6)])])

    def aln(name, nodes):
        return vg.Alignment(name=name, path=vg.Path(mapping=[
            vg.Mapping(position=vg.Position(node_id=n),
                       edit=[vg.Edit(from_length=10)]) for n in nodes]))

    gam = tmp_path / "a.gam"
    stream.write_messages(str(gam), [aln("r1", [1, 2, 3]), aln("r2", [2, 3, 4])])
    reads = tmp_path / "r.fastq"
    reads.write_text("@r1\nACGT\n+\n!!!!\n@r2\nACGT\n+\n!!!!\n")
    out = _same_as_jax(capsys, tmp_path, "alignment_overlap",
                       [str(graph), str(gam), "0.5", "0.3", str(reads),
                        "{out}/o.gfa"])
    text = (out / "o.gfa").read_text()
    assert "S\tr1\t" in text and "S\tr2\t" in text
    assert any(line.startswith("L\t") for line in text.split("\n"))


def test_maf_to_alignment(tmp_path, capsys):
    graph = tmp_path / "g.vg"
    stream.write_messages(str(graph), [vg.Graph(node=[
        vg.Node(id=1, sequence="ACGTA"), vg.Node(id=2, sequence="GGTTC")])])
    ref = tmp_path / "ref.gam"
    stream.write_messages(str(ref), [vg.Alignment(name="ref", path=vg.Path(mapping=[
        vg.Mapping(position=vg.Position(node_id=1), edit=[vg.Edit(to_length=5)]),
        vg.Mapping(position=vg.Position(node_id=2), edit=[vg.Edit(to_length=5)]),
    ]))])
    maf = tmp_path / "x.maf"
    maf.write_text(
        "a score=1\ns ref 2 6 + 10 GTAGGT\ns read_1 0 6 + 6 GTAGGT\n\n"
    )
    out = _same_as_jax(capsys, tmp_path, "maf_to_alignment",
                       [str(graph), str(ref), str(maf), "{out}/out.gam",
                        "{out}/out.fa"])
    alns = stream.read_messages(str(out / "out.gam"), vg.Alignment)
    assert len(alns) == 1
    assert [m.position.node_id for m in alns[0].path.mapping] == [1, 2]
    assert ">read_1" in (out / "out.fa").read_text()


@pytest.mark.parametrize("reverse", [[], ["1"]], ids=["forward", "reverse"])
def test_read_index_to_id(tmp_path, capsys, reverse):
    """CSV minimizer hits -> seed GAM, with the reverse-coordinate flip and
    the (node, read) dedup."""
    fastq = tmp_path / "r.fastq"
    fastq.write_text("@readA\nACGTACGTAC\n+\n!!!!!!!!!!\n@readB\nTTTTGGGG\n+\n!!!!!!!!\n")
    csv = tmp_path / "hits.csv"
    csv.write_text("5,0,3\n5,0,7\n9,1,2\n")
    out = _same_as_jax(capsys, tmp_path, "read_index_to_id",
                       [str(fastq), str(csv), "{out}/seeds.gam", *reverse])
    alns = stream.read_messages(str(out / "seeds.gam"), vg.Alignment)
    got = [(a.name, a.query_position, a.path.mapping[0].position.node_id)
           for a in alns]
    if reverse:
        assert got == [("readA", 10 - 3 - 1, 5), ("readB", 8 - 2 - 1, 9)]
    else:
        assert got == [("readA", 3, 5), ("readB", 2, 9)]


def test_supported_subgraph(tmp_path, capsys):
    """Edges kept iff some alignment path traverses them."""
    g = vg.Graph(
        node=[vg.Node(id=i, sequence="ACGT") for i in (1, 2, 3)],
        edge=[vg.Edge(from_=1, to=2), vg.Edge(from_=2, to=3)],
    )
    gpath = tmp_path / "g.vg"
    stream.write_messages(str(gpath), [g])
    apath = tmp_path / "a.gam"
    stream.write_messages(str(apath), [vg.Alignment(name="r", path=vg.Path(
        mapping=[vg.Mapping(position=vg.Position(node_id=1)),
                 vg.Mapping(position=vg.Position(node_id=2))]))])
    out = _same_as_jax(capsys, tmp_path, "supported_subgraph",
                       [str(gpath), str(apath), "{out}/out.vg"])
    sub = stream.read_messages(str(out / "out.vg"), vg.Graph)[0]
    assert len(sub.node) == 3
    assert [(e.from_, e.to) for e in sub.edge] == [(1, 2)]


def test_buffered_writer(capsys):
    from graphaligner_tpu_torch.utils import BufferedWriter

    w = BufferedWriter(sys.stdout)
    w.write("a", 1, "b")
    w << "c"
    w.flush()
    assert capsys.readouterr().out == "a1bc\n"


_IMPORT_ALL = BLOCK_JAX + r"""
import importlib, pkgutil
import graphaligner_tpu_torch.tools as tools
import graphaligner_tpu_torch.utils as utils
names = []
for pkg in (tools, utils):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"{pkg.__name__}.{m.name}")
        names.append(m.name)
print(" ".join(sorted(names)))
rc = tools.compare_alignments.main(sys.argv[2:])
""" + NO_JAX_LOADED + r"""
sys.exit(rc)
"""


def test_tools_and_utils_import_where_jax_is_absent():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, str(ROOT), str(SIM / "truth.gam"),
         str(SIM / "golden_b35" / "out.gam"), str(SIM / "bubbles.vg")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    first, rest = proc.stdout.split("\n", 1)
    want = {m.name for pkg in ("tools", "utils") for m in pkgutil.iter_modules(
        [str(ROOT / "graphaligner_tpu" / pkg)])}
    # the port's tracer takes the place of the JAX package's metrics module
    want = want - {"metrics"} | {"trace"}
    assert set(first.split()) == want and len(want) == 18
    assert rest == (SIM / "compare_golden.txt").read_text()
