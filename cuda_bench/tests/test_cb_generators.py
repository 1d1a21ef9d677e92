"""The benchmark's generators: the graph is what vg construct builds from
the drawn reference and variants, at the configuration's rates; reads
are the same for the same seed, never repeat, follow the mix, and lie on
a path of the graph from their seed, on either strand."""

import json
from pathlib import Path

import numpy as np
import pytest

from cuda_bench.gen import graph_generator
from cuda_bench.gen.reads import ReadMaker
from cuda_bench.reference import seeded, vg

CB = Path(__file__).resolve().parents[1]
CHR20 = json.loads((CB / "configs" / "chr20_1kg_af05.json").read_text())["graph"]
HIFI = json.loads((CB / "traffic" / "hifi13k.json").read_text())
SHORT = dict(HIFI, read_len={"min": 300, "max": 420})
EXACT = dict(SHORT, errors=dict(HIFI["errors"], sub=0, ins=0, **{"del": 0}))


def small(L, **kw):
    return graph_generator("vg_construct").build(
        dict(CHR20, ref_length=L, **kw), 5)


def test_graph_is_what_vg_construct_builds():
    sg = small(1_000_000)
    ids, rev, lens, codes, e_from, e_to = sg.handed["arrays"]
    assert lens.max() == 32 and lens.min() >= 1
    a = np.diff(sg.allele_off).reshape(-1, 2)
    snp = (a[:, 0] == 1) & (a[:, 1] == 1)
    ins, dele = a[:, 0] == 0, a[:, 1] == 0
    assert (snp | ins | dele).all() and not (ins & dele).any()
    n = len(a)
    # the record rate, less those dropped for meeting the site before
    assert 1_000_000 / CHR20["variant_spacing_bp"] * 0.93 < n < \
        1_000_000 / CHR20["variant_spacing_bp"]
    assert abs(snp.mean() - CHR20["snp_share"]) < 0.01
    assert abs(ins.mean() - CHR20["ins_share"]) < 0.005
    # a SNP's two allele nodes hold different bases
    first = sg.allele_off[:-1].reshape(-1, 2)[snp]
    assert (sg.allele_codes[first[:, 0]] != sg.allele_codes[first[:, 1]]).all()
    # the reference path (segments and first alleles) spells the reference
    assert np.diff(sg.seg_off).sum() + a[:, 0].sum() == 1_000_000
    # bubbles only: in-degree 2 at most, both strands
    assert np.bincount(e_to).max() == 2 and np.bincount(e_from).max() == 2
    # every run of reference bases and every allele cut at 32 bp
    pieces = np.concatenate([np.diff(sg.seg_off), a.reshape(-1)])
    assert len(ids) == 2 * (-(-pieces // 32)).sum()
    assert len(codes) == lens.sum() == 2 * pieces.sum()


def test_reads_same_for_a_seed_and_never_repeated():
    maker = ReadMaker(small(60_000), SHORT, "cpu")
    a = maker.reads(600, 2**31 + 12345, 1, "r")
    b = maker.reads(600, 2**31 + 12345, 1, "r")
    assert a == b
    names = [r[0] for r in a]
    seqs = [r[1] for r in a]
    assert len(set(names)) == len(a) and len(set(seqs)) == len(a)
    other = maker.reads(600, 2**31 + 12345, 2, "w")
    assert not set(seqs) & {r[1] for r in other}
    assert maker.reads(8, 2**31 + 12346, 1, "r") != a[:8]
    assert set("".join(seqs)) <= set("ACGT")


def test_lengths_and_errors_follow_the_mix():
    sg = small(120_000)
    exact = dict(EXACT, read_len=HIFI["read_len"])
    lens = np.array([len(s) for _, s, _ in
                     ReadMaker(sg, exact, "cpu").reads(400, 9, 1, "r")])
    rl = HIFI["read_len"]
    assert lens.min() >= rl["min"] and lens.max() <= rl["max"]
    assert abs(lens.mean() - rl["mean"]) < 4 * rl["sd"] / 20
    assert abs(lens.std() - rl["sd"]) < 0.15 * rl["sd"]
    # errors: reads aligned to their own truth path, edits per base
    noisy = dict(SHORT, errors=dict(HIFI["errors"], sub=0.01, ins=0.02,
                                    **{"del": 0.02}))
    g = seeded.load_graph(sg.handed)
    edits = bases = 0
    for name, seq, seed in ReadMaker(sg, noisy, "cpu").reads(30, 9, 1, "r"):
        ans = seeded.align(g, name, seq, [seed], 35, 0)
        edits += vg.Alignment.decode(ans.payload).score
        bases += len(seq)
    assert 0.03 < edits / bases < 0.07


@pytest.mark.parametrize("at", ["uniform", "first"])
def test_error_free_reads_follow_a_path_from_their_seed(at):
    """With no errors a read is a path of the graph through its seed on
    the seed's strand: the reference aligns it with score 0 from there.
    Reads take alt alleles, start anywhere and are seeded mid-read on
    both strands where the mix says so."""
    sg = small(30_000, alt_share=0.3)
    maker = ReadMaker(sg, dict(EXACT, seed=dict(HIFI["seed"], at=at)), "cpu")
    reads = maker.reads(16, 77, 1, "r")
    g = seeded.load_graph(sg.handed)
    backbone = "".join("ACGT"[c] for c in sg.seg_codes)
    for name, seq, seed in reads:
        ans = seeded.align(g, name, seq, [seed], 35, 0)
        assert not ans.failed
        assert vg.Alignment.decode(ans.payload).score == 0
    seeds = [s for _, _, s in reads]
    assert {r for _, _, r in seeds} == {False, True}
    start = [p < 32 for _, p, _ in seeds]
    assert all(start) if at == "first" else sum(start) < len(reads) / 2
    assert any(s not in backbone for _, s, _ in reads)
