"""The port on graphs of in-degree 5 to 32 against the JAX package (past
32: test_torch_in_degree_wide.py).

Past 5 in-neighbours the JAX package runs XLA code: its cell pass
``cell_pass_xla`` (graphaligner_tpu/core/engine_banded.py:883) and, past 4,
its walk ``walk_batch`` (core/backtrace_device.py:50). The port runs the
wide routes of K1 and K2, whose plain versions run here. Tolerance zero:
every output is integer.

- ``banded_scan``, and so ``slice_cells_plain`` on every slice, against
  the JAX scan on seeded random graphs of in-degree 6, 8 and 11 (11 crosses
  into a third pred plane), from random carries and with a back edge, so
  the fixpoint runs; and on the seeded problems of the small multi-allelic
  corpus (in-degree 8);
- the plain wide walk, decoded by the native decoder, against walk_batch on
  the same tables at in-degree 5 and 8: traces and fail flags at
  walk_batch's budget and at one the longest lane cannot meet;
- the whole slice, ``align_reads_seeded_batch``, on the small corpus
  (tests/fixtures/torch/multiallelic_small: 40 segments, 6 reads of 1,500
  bp) against the JAX package's goldens at -b 35 and -b 5 -B 20;
- ``banded_cell_plain`` at in-degree 6 and 8 against the Pallas kernel
  (in test_torch_banded_cell.py), and long mode past in-degree 4 raising;
- a graph of in-degree 33 aligning, and a launch whose tables do not fit
  in shared memory raising with its limit.

The JAX side runs in one subprocess (this file run as a script) with
``XLA_FLAGS=--xla_cpu_use_fusion_emitters=false``: XLA's CPU fusion
emitters make cell_pass_xla exponentially slow in the in-degree
(tests/fixtures/torch/make_goldens.py says why); the flag changes only
how XLA generates CPU code. ``pred_tab`` and ``pred_prev`` are compared on
their first plane under 0x3FFFFFFF past 5 in-neighbours: the JAX package
packs them into one int32, which keeps the first five fields and two bits
of the sixth (bits 30-31) and drops the rest; it reads them nowhere on
this path (its walk reads bands and columns). The port keeps every field,
in further planes, which its wide walk reads.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FIX = HERE / "fixtures"
SMALL = FIX / "torch" / "multiallelic_small"
XLA_CPU_FLAG = "--xla_cpu_use_fusion_emitters=false"
EMPTY = 2**31 - 1
INF = 1 << 20
PRED_MASK = 0x3FFFFFFF
NM, BW = 32, 35


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions issue many small ops: one intra-op thread a
    worker keeps them from oversubscribing the CPU the workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ inputs
def _random_graph(K, seed):
    """GFA text of a seeded multi-allelic graph whose every site has K
    alleles (in-degree K), with one back link from an allele of the second
    site to one of the first, which closes a cycle (and keeps the in-degree
    at K on both strands); and its segment ids."""
    from graphaligner_tpu_torch.graph.synthetic import make_multiallelic

    gfa, _ = make_multiallelic(10, 0, 0, seed, counts=(K,), shares=(1.0,))
    seqs = [line.split("\t") for line in gfa.splitlines()
            if line.startswith("S")]
    segs = [int(n) for _, n, s in seqs if len(s) >= 32]
    assert segs[0] + 1 < segs[1] and segs[1] + 1 < segs[2]
    gfa += f"L\t{segs[1] + 1}\t+\t{segs[0] + 1}\t+\t0M\n"
    return gfa, segs


def _port_graph(path):
    from graphaligner_tpu_torch.core.tables import build_graph_tables
    from graphaligner_tpu_torch.graph import graph_from_gfa_file

    graph = graph_from_gfa_file(str(path))
    return graph, build_graph_tables(graph)


def _random_scan_inputs(tables, graph, segs, K, seed, B=8, S=3, Cm=128):
    """Scan arguments from random carries: each lane's band is a window of
    the graph around a random segment (topo-rank sorted), with random
    scores and INF holes, random read codes, some lanes short or past
    their first slice."""
    rng = np.random.default_rng(seed)
    N = tables.num_nodes
    rank = tables.topo_rank
    ids = np.full((B, NM), EMPTY, np.int32)
    for b in range(B):
        # lane 0's band holds the cycle
        j = int(rng.integers(0, len(segs) - 2)) if b else 0
        lo = graph.node_lookup[segs[j] * 2]
        hi = graph.node_lookup[segs[j + 2] * 2]
        nodes = [n for n in range(min(lo, hi), max(lo, hi) + 1)
                 if graph.node_ids[n] % 2 == 0][:NM]
        nodes = sorted(nodes, key=lambda n: rank[n])
        ids[b, : len(nodes)] = nodes
    valid = ids < EMPTY
    lens = np.where(valid, tables.node_len[np.clip(ids, 0, N - 1)], 0)
    c_used = lens.sum(1)
    node_min = np.where(valid, rng.integers(0, 40, (B, NM)), INF)
    node_min[rng.random((B, NM)) < 0.15] = INF
    node_end = np.where(node_min < INF, node_min + rng.integers(0, 6, (B, NM)),
                        INF)
    send = rng.integers(0, 50, (B, Cm))
    send[(np.arange(Cm)[None] >= c_used[:, None])
         | (rng.random((B, Cm)) < 0.1)] = INF
    init_min = np.where(valid & (node_min < INF), node_min, INF).min(1)
    codes = rng.integers(0, 4, (B, S * 64)).astype(np.uint8)
    steps = np.full(B, S, np.int32)
    steps[1] = S - 1
    start = rng.integers(0, 2, B).astype(np.int32)
    args = (codes, np.full(B, S * 64 + 128, np.int32), steps, start,
            np.full((S, B), BW, np.int32), ids, send.astype(np.int32),
            node_min.astype(np.int32), node_end.astype(np.int32),
            init_min.astype(np.int32))
    return args, dict(S_max=S, Nm=NM, Cm=Cm)


def _seeded_scan_inputs(tables, graph, reads, seeds, Cm=288):
    """Scan arguments of the corpus's seeded forward problems, one a lane,
    each from its seed node at score 0."""
    from graphaligner_tpu_torch.core.align import _pad_to_word
    from graphaligner_tpu_torch.core.engine import encode_read
    from graphaligner_tpu_torch.core.tables import make_seed_carry

    probs = []
    for r in reads:
        node_id, pos, rev = seeds[r.seq_id][0]
        probs.append((_pad_to_word(r.sequence[pos:]),
                      graph.node_lookup[node_id * 2 + (1 if rev else 0)]))
    B = len(probs)
    S = max(len(p[0]) // 64 for p in probs)
    codes = np.full((B, S * 64), 14, np.uint8)
    seq_len, steps, starts = (np.zeros(B, np.int32) for _ in range(3))
    for i, (seq, node) in enumerate(probs):
        codes[i, : len(seq)] = encode_read(seq)
        seq_len[i], steps[i], starts[i] = len(seq), len(seq) // 64, node
    args = (codes, seq_len, steps, np.zeros(B, np.int32),
            np.full((S, B), BW, np.int32),
            *make_seed_carry(tables, starts, NM, Cm))
    return args, dict(S_max=S, Nm=NM, Cm=Cm)


def _small_corpus():
    from graphaligner_tpu_torch.io import load_fastq
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits

    graph, tables = _port_graph(SMALL / "graph.gfa")
    reads = load_fastq(str(SMALL / "reads.fastq"))
    seeds = load_seed_hits(str(SMALL / "seeds.gam"), [r.seq_id for r in reads])
    return graph, tables, reads, seeds


def _walk_corpus(K, tmp):
    """A seeded multi-allelic graph of in-degree K (every site K alleles)
    and 8 reads of 600 to 1,300 bp from it, one seed each."""
    from graphaligner_tpu_torch.graph.synthetic import make_multiallelic
    from graphaligner_tpu_torch.io.fastq import FastQ

    gfa, reads = make_multiallelic(30, 8, 1300, 100 + K, counts=(K,),
                                   shares=(1.0,))
    path = tmp / f"walk{K}.gfa"
    path.write_text(gfa)
    graph, tables = _port_graph(path)
    lens = [600 + 100 * i for i in range(8)]
    fq = [FastQ(n, s[:L], "I" * L) for (n, s, _), L in zip(reads, lens)]
    seeds = {n: [(node, 0, False)] for n, _, node in reads}
    return path, graph, tables, fq, seeds


def _walk_tables(out, steps, Cm):
    """The port's walk tables ([K+1, ...], entry 0 the pad slice below the
    window) and walk_batch's ([7, B, K*Cm] columns, [K, Nm, B] bands) from
    one scan's outputs, every slice at or past a lane's steps masked as the
    walk consolidation masks it."""
    S, _, _, B = out["cols"].shape
    keep = np.arange(S)[:, None] < steps[None, :]  # [S, B]
    cols = np.where(keep[:, None, None, :], out["cols"], 0)
    band = np.where(keep[:, None, :], out["band_ids"], EMPTY)
    port = [np.concatenate([np.full_like(a[:1], f), a]) for a, f in (
        (cols, 0), (band, EMPTY),
        (np.where(keep[:, None, :], out["lens_tab"], 0), 0),
        (np.where(keep[:, None, :], out["pred_tab"], 0), 0),
        (np.where(keep[:, None, :], out["pred_prev"], 0), 0),
        (np.where(keep[:, None, :], out["codes"], 0), 0),
    )]
    jax_cols = np.ascontiguousarray(cols.transpose(1, 3, 0, 2).reshape(
        7, B, S * Cm))
    return port, jax_cols, np.ascontiguousarray(band)


def _walk_starts(out, steps, tables):
    """Each lane's backtrace start in its last slice: its first cell of
    least score (position, slot, offset, score)."""
    B = len(steps)
    w0, slot0, off0, score0 = (np.zeros(B, np.int64) for _ in range(4))
    for b in range(B):
        s = int(steps[b]) - 1
        band = out["band_ids"][s, :, b]
        lens = np.where(band < EMPTY, out["lens_tab"][s, :, b], 0)
        sends = out["cols"][s, 5, : lens.sum(), b]
        cell = int(np.argmin(sends))
        slot = int(np.searchsorted(np.cumsum(lens), cell, side="right"))
        off = cell - int(np.cumsum(lens)[slot] - lens[slot])
        w0[b] = tables.node_start[band[slot]] + off
        slot0[b], off0[b], score0[b] = slot, off, sends[cell]
    return w0, slot0, off0, score0


# ------------------------------------------------------------- JAX process
def _jax_main(job_dir):
    """Every job of ``job_dir`` through the JAX package, in name order, each
    result written as ``<name>.out.npz`` once complete."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from graphaligner_tpu.core.backtrace_device import walk_batch
    from graphaligner_tpu.core.engine_banded import (
        banded_scan,
        build_graph_tables,
    )
    from graphaligner_tpu.core.reach import ensure_reach
    from graphaligner_tpu.graph.bigraph import graph_from_gfa_file

    job_dir = pathlib.Path(job_dir)
    for job in sorted(job_dir.glob("*.job.npz")):
        name = job.name[: -len(".job.npz")]
        z = dict(np.load(job))
        tables = build_graph_tables(graph_from_gfa_file(str(z.pop("gfa"))))
        if name.startswith("scan"):
            S_max, Nm, Cm = (int(x) for x in z.pop("shape"))
            reach = ensure_reach(tables, BW + 63)
            ref = banded_scan(
                *tables.device_args(), *[z[f"a{i}"] for i in range(10)],
                S_max=S_max, Nm=Nm, Cm=Cm, _proj="reach", reach=reach,
            )
            res = {k: np.asarray(v) for k, v in ref.items()}
            res["k_in"] = np.int32(tables.k_in)
        else:
            res = {"k_in": np.int32(tables.k_in)}
            for i, T in enumerate(z["T_max"]):
                trace, fail = walk_batch(
                    tables, z["cols_tab"], z["band_tab"], z["codes"],
                    z["seq_len"], z["seed"], z["start_w"], z["keeps"],
                    T_max=int(T),
                )
                res[f"trace{i}"] = np.asarray(trace)
                res[f"fail{i}"] = np.asarray(fail)
        tmp = job_dir / f"{name}.tmp.npz"
        np.savez(tmp, **res)
        os.replace(tmp, job_dir / f"{name}.out.npz")


class _JaxJobs:
    """The JAX subprocess over one directory of jobs; ``get`` waits for a
    job's results."""

    def __init__(self, job_dir):
        self.dir = job_dir
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " "
                            + XLA_CPU_FLAG).strip()
        self.log = open(job_dir / "jax.log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, __file__, str(job_dir)], cwd=str(ROOT), env=env,
            stdout=self.log, stderr=subprocess.STDOUT,
        )

    def get(self, name, timeout=900):
        out = self.dir / f"{name}.out.npz"
        t0 = time.time()
        while not out.exists():
            rc = self.proc.poll()
            if rc is not None and not out.exists():
                self.log.flush()
                raise RuntimeError(f"the JAX process ended ({rc}) before "
                                   f"{name}: "
                                   f"{(self.dir / 'jax.log').read_text()[-3000:]}")
            if time.time() - t0 > timeout:
                raise TimeoutError(name)
            time.sleep(0.2)
        return dict(np.load(out))

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()


RANDOM_K = (6, 8, 11)
WALK_K = (5, 8)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The inputs of every JAX job, written before the JAX process starts:
    the random scans, the small corpus's scan and the walks (whose tables
    come from the port's scans: the walk comparison takes one table into
    both walks). Yields (jobs, port-side inputs by name)."""
    from graphaligner_tpu_torch.core.batch_align import _quantize_k
    from graphaligner_tpu_torch.core.engine_banded import banded_scan
    from graphaligner_tpu_torch.core.reach import ensure_reach
    from graphaligner_tpu_torch.core.tables import device_tables

    tmp = tmp_path_factory.mktemp("jax_jobs")
    port = {}

    def scan_job(name, gfa_path, args, shape):
        np.savez(tmp / f"{name}.job.npz", gfa=str(gfa_path),
                 shape=np.array([shape["S_max"], shape["Nm"], shape["Cm"]]),
                 **{f"a{i}": a for i, a in enumerate(args)})

    for K in RANDOM_K:
        gfa, segs = _random_graph(K, K)
        path = tmp / f"rand{K}.gfa"
        path.write_text(gfa)
        graph, tables = _port_graph(path)
        args, shape = _random_scan_inputs(tables, graph, segs, K, K)
        scan_job(f"scan_rand{K}", path, args, shape)
        port[f"scan_rand{K}"] = (tables, args, shape)
    graph, tables, reads, seeds = _small_corpus()
    args, shape = _seeded_scan_inputs(tables, graph, reads, seeds)
    scan_job("scan_small", SMALL / "graph.gfa", args, shape)
    port["scan_small"] = (tables, args, shape)
    for K in WALK_K:
        path, graph, tables, fq, seeds = _walk_corpus(K, tmp)
        args, shape = _seeded_scan_inputs(tables, graph, fq, seeds)
        dt = device_tables(tables, ensure_reach(tables, BW + 63), "cpu")
        out = {k: v.numpy() for k, v in
               banded_scan(dt, *args, **shape).items()}
        steps = args[2]
        ptabs, jcols, jband = _walk_tables(out, steps, shape["Cm"])
        w0, slot0, off0, score0 = _walk_starts(out, steps, tables)
        T_full = _quantize_k(int(steps.max())) * 80 + 64
        T_cut = 64 * int(steps.max()) - 1  # the longest lane needs more
        seed_nodes = args[5][:, 0]
        np.savez(tmp / f"walk{K}.job.npz", gfa=str(path), cols_tab=jcols,
                 band_tab=jband, codes=args[0], seq_len=args[1],
                 seed=seed_nodes, start_w=w0.astype(np.int32), keeps=steps,
                 T_max=np.array([T_full, T_cut]))
        port[f"walk{K}"] = (tables, dt, ptabs, args, steps, seed_nodes,
                            (w0, slot0, off0, score0), (T_full, T_cut))
    runner = _JaxJobs(tmp)
    yield runner, port
    runner.close()


def _assert_scan_equal(got, ref, k_in):
    assert set(got) == set(ref) - {"k_in"}
    for key in sorted(got):
        have, want = got[key].numpy(), ref[key]
        if key in ("pred_tab", "pred_prev") and k_in > 5:
            Nm = want.shape[1]
            assert have.shape[1] == -(-k_in // 5) * Nm, key
            have, want = have[:, :Nm] & PRED_MASK, want & PRED_MASK
        assert have.dtype == want.dtype, key
        np.testing.assert_array_equal(have, want, err_msg=key)


@pytest.mark.parametrize("K", RANDOM_K)
def test_slice_cells_plain_matches_xla_cell_pass_on_random_slices(
        K, jobs, monkeypatch):
    """The port's scan from random carries on a random graph of in-degree
    K, every slice through slice_cells_plain, against the JAX scan, whose
    cell pass there is cell_pass_xla; the back edge makes some lane take
    more than one cell pass."""
    import graphaligner_tpu_torch.ops.banded_cell as k1
    from graphaligner_tpu_torch.core.engine_banded import banded_scan
    from graphaligner_tpu_torch.core.reach import ensure_reach
    from graphaligner_tpu_torch.core.tables import device_tables

    runner, port = jobs
    tables, args, shape = port[f"scan_rand{K}"]
    assert tables.k_in == K
    passes = []
    orig_slice, orig_cell = k1.slice_cells_plain, k1.banded_cell_plain

    def count_slice(*a, **kw):
        passes.append(0)
        return orig_slice(*a, **kw)

    def count_cell(*a, **kw):
        passes[-1] += 1
        return orig_cell(*a, **kw)

    monkeypatch.setattr(k1, "slice_cells_plain", count_slice)
    monkeypatch.setattr(k1, "banded_cell_plain", count_cell)
    dt = device_tables(tables, ensure_reach(tables, BW + 63), "cpu")
    got = banded_scan(dt, *args, **shape)
    assert len(passes) == shape["S_max"] and max(passes) > 1
    ref = runner.get(f"scan_rand{K}")
    assert int(ref["k_in"]) == K
    _assert_scan_equal(got, ref, K)
    # the further planes hold in-neighbours 5.. where the JAX word cannot
    high = got["pred_tab"].numpy()[:, shape["Nm"]:]
    assert ((high >> 5) & 1).any()


def test_banded_scan_matches_jax_on_the_small_multiallelic_corpus(jobs):
    from graphaligner_tpu_torch.core.engine_banded import banded_scan
    from graphaligner_tpu_torch.core.reach import ensure_reach
    from graphaligner_tpu_torch.core.tables import device_tables

    runner, port = jobs
    tables, args, shape = port["scan_small"]
    assert tables.k_in == 8
    dt = device_tables(tables, ensure_reach(tables, BW + 63), "cpu")
    got = banded_scan(dt, *args, **shape)
    _assert_scan_equal(got, runner.get("scan_small"), 8)


def _jax_traces(trace, fail):
    """walk_batch's per-lane forward traces after _walk_xla's post-check
    (None for a failed lane)."""
    out = []
    for b in range(trace.shape[2]):
        rows = trace[:, 1, b]
        n = int(np.argmax(rows == -2)) if (rows == -2).any() else len(rows)
        arr = np.stack([trace[:n, 0, b], rows[:n]], axis=1).astype(np.int64)
        if fail[b] or len(arr) < 2 or arr[-1, 1] != -1 or arr[-2, 1] != 0:
            out.append(None)
        else:
            out.append(arr[-2::-1])
    return out


@pytest.mark.parametrize("K", WALK_K)
def test_plain_wide_walk_matches_walk_batch(K, jobs):
    """The plain wide walk (byte codes, Bb=1) and the native decoder against
    walk_batch on the same tables: every lane's trace and fail flag at
    walk_batch's budget (all lanes walk, through in-neighbours past 4) and
    at one the longest lane cannot meet (it fails in both, shorter lanes
    walk). The stored tables are lane-last; the wide route takes them
    lane-major (lane_major_tables), and the plain walk turns them back
    (lane_last_tables), which inverts it."""
    from graphaligner_tpu_torch.core.batch_align import _walk_init_state
    from graphaligner_tpu_torch.io import native
    from graphaligner_tpu_torch.ops import walk_moves as k2

    runner, port = jobs
    tables, dt, ptabs, args, steps, seed_nodes, starts, budgets = (
        port[f"walk{K}"])
    assert tables.k_in == K
    w0, slot0, off0, score0 = starts
    B = len(steps)
    ref = runner.get(f"walk{K}")
    tabs = [torch.from_numpy(np.ascontiguousarray(a)) for a in ptabs]
    major = k2.lane_major_tables(tabs)
    assert all(torch.equal(g, w)
               for g, w in zip(k2.lane_last_tables(major), tabs))
    row1 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int32)[None])
    init = torch.from_numpy(_walk_init_state(
        B, steps, slot0.astype(np.int32), off0.astype(np.int32),
        score0.astype(np.int32)))
    big_k = set()
    for i, T in enumerate(budgets):
        n0 = k2.LAUNCHES + k2.LAUNCHES_WIDE
        moves, fail, _, used = k2.walk_moves(
            *major, dt.bt_bits_lut, row1(args[1]), row1(seed_nodes),
            row1(np.zeros(B)), init, K_in=K, steps=T, W_cap=T)
        assert k2.LAUNCHES + k2.LAUNCHES_WIDE == n0  # the plain version
        assert moves.shape[0] == -(-(T + 1) // 4)
        m = moves.numpy().view(np.uint32)
        big_k |= {int(c) for j in range(4)
                  for c in np.unique((m >> (8 * j)) & 255) if c >= 68}
        w, r, n = native.decode_moves_batch(
            m, np.arange(B, dtype=np.int32), w0, steps.astype(np.int64) * 64 - 1,
            np.ascontiguousarray(tables.node_start, dtype=np.int64),
            np.ascontiguousarray(tables.node_end, dtype=np.int64),
            np.ascontiguousarray(tables.pos_to_node),
            np.ascontiguousarray(tables.in_nbrs), T + 1, 1, code_bits=8)
        want = _jax_traces(ref[f"trace{i}"], ref[f"fail{i}"])
        for b in range(B):
            ok = not fail[0, b] and n[b] >= 1 and r[b, 0] == 0
            assert ok == (want[b] is not None), (T, b)
            if ok:
                got = np.stack([w[b, : n[b]], r[b, : n[b]]], axis=1)
                np.testing.assert_array_equal(got, want[b])
        if i == 0:
            assert all(x is not None for x in want)
        else:
            lost = [b for b in range(B) if want[b] is None]
            assert lost and int(np.argmax(steps)) in lost and len(lost) < B
    assert big_k  # moves through in-neighbours 4 and past


@pytest.mark.parametrize("bw,ramp,golden,reach", [
    (35, 0, "out_b35.gam", True), (5, 20, "out_b5_B20.gam", True),
    (5, 20, "out_b5_B20.gam", False)])
def test_slice_matches_jax_golden_on_the_small_multiallelic_corpus(
        bw, ramp, golden, reach, monkeypatch):
    """align_reads_seeded_batch on the small corpus (in-degree 8) byte for
    byte against the JAX package's golden, with no host fallback, through
    both wide routes' plain versions; at -b 5 -B 20 also under
    GA_REACH_MAXN=0, every band projected iteratively (out-degree 8)."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.io import stream, vg
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import walk_moves as k2

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    if not reach:
        monkeypatch.setenv("GA_REACH_MAXN", "0")
    graph, tables, reads, seeds = _small_corpus()
    calls = {"k1": 0, "k2": 0}
    orig1, orig2 = k1.slice_cells_plain, k2.walk_moves_plain

    def c1(*a, **kw):
        calls["k1"] += 1
        return orig1(*a, **kw)

    def c2(*a, **kw):
        calls["k2"] += 1
        assert kw["K_in"] == 8 and kw["Bb"] == 1
        return orig2(*a, **kw)

    monkeypatch.setattr(k1, "slice_cells_plain", c1)
    monkeypatch.setattr(k2, "walk_moves_plain", c2)
    aligner = ba.BandedBatchAligner(graph, bw, ramp, "cpu")
    assert (aligner._dt.reach is not None) == reach
    res = ba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    assert calls["k1"] and calls["k2"]
    mine = []
    for r in reads:
        aln = vg.Alignment.decode(res[r.seq_id].alignment.encode())
        for m in aln.path.mapping:
            m.position.node_id //= 2
        mine.append(aln.encode())
    want = [a.encode() for a in
            stream.read_messages(str(SMALL / golden), vg.Alignment)]
    assert mine == want


def test_long_mode_past_in_degree_4_raises(monkeypatch):
    """The JAX package's long walk is its Pallas kernel, which asserts
    K_in <= 4: the port raises where it would walk."""
    from graphaligner_tpu_torch.core import batch_align as ba

    graph, tables, reads, seeds = _small_corpus()
    # the class attribute: the 2x retry tier reads it too
    monkeypatch.setattr(ba.BandedBatchAligner, "LONG_WINDOW", 8)
    aligner = ba.BandedBatchAligner(graph, 35, 0, "cpu")
    with pytest.raises(NotImplementedError, match="in-degree <= 4"):
        ba.align_reads_seeded_batch(graph, aligner, reads[:1], seeds)
    assert aligner._long_mode


def test_in_degree_33_aligns(tmp_path, monkeypatch):
    """A graph of in-degree 33 (a converging tree of 33 leaves joining one
    segment) takes the aligner, which once refused it, and reads from that
    segment on align through both wide routes with no host fallback."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.graph.synthetic import make_converging
    from graphaligner_tpu_torch.io.fastq import FastQ
    from graphaligner_tpu_torch.ops import banded_cell as k1
    from graphaligner_tpu_torch.ops import walk_moves as k2

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    gfa, _ = make_converging(4, 0, 0, 1, sites=[("tree", 33), ("site", 2),
                                                ("site", 3)])
    (tmp_path / "g.gfa").write_text(gfa)
    graph, tables = _port_graph(tmp_path / "g.gfa")
    assert tables.k_in == 33
    rows = [line.split("\t") for line in gfa.splitlines()]
    seqs = {int(r[1]): r[2] for r in rows if r[0] == "S"}
    links = [(int(r[1]), int(r[3])) for r in rows if r[0] == "L"]
    join = next(n for n in seqs if sum(b == n for _, b in links) == 33)
    path = [join]
    while len(path) < 5:
        path.append(next(b for a, b in links if a == path[-1]))
    exact = "".join(seqs[n] for n in path)
    mutated = "".join("A" if i % 40 == 20 and c != "A" else c
                      for i, c in enumerate(exact))
    reads = [FastQ(f"r{i}", q, "I" * len(q))
             for i, q in enumerate((exact, mutated))]
    calls = {"k1": 0, "k2": 0}
    orig1, orig2 = k1.slice_cells_plain, k2.walk_moves_plain

    def c1(*a, **kw):
        calls["k1"] += 1
        return orig1(*a, **kw)

    def c2(*a, **kw):
        calls["k2"] += 1
        return orig2(*a, **kw)

    monkeypatch.setattr(k1, "slice_cells_plain", c1)
    monkeypatch.setattr(k2, "walk_moves_plain", c2)
    aligner = ba.BandedBatchAligner(graph, 35, 0, "cpu")
    res = ba.align_reads_seeded_batch(
        graph, aligner, reads, {r.seq_id: [(join, 0, False)] for r in reads})
    assert calls["k1"] and calls["k2"]
    for r in reads:
        assert not res[r.seq_id].alignment_failed
        assert res[r.seq_id].alignment.score < 2**31 - 1


def test_launch_past_shared_memory_raises_naming_its_limit():
    """What bounds the wide route is the card's shared memory, and its
    tables no longer grow with the in-degree (a hash table of the bands'
    ids and a list of Nm bytes a slot, the pred planes written straight
    out): WIDE_LANES lanes a block at any in-degree and every tier; only a
    Cm past any tier makes one lane's tables pass a block, and the launch
    raises naming the in-degree, Cm, Nm and bytes (K2's raise:
    test_torch_walk_moves.py); below that a block's lanes halve to fit (the
    narrow route's 8 at Cm=4608)."""
    from graphaligner_tpu_torch.ops import banded_cell as k1

    assert k1.slice_lanes(32, 288, 5) == k1.SLICE_LANES
    assert k1.slice_lanes(32, 288, 8) == k1.WIDE_LANES
    for K_in in (6, 200, 4131, 100_000):
        assert k1.slice_smem(32, 2304, 1, K_in) == k1.slice_smem(32, 2304, 1,
                                                                 6)
        assert k1.slice_lanes(32, 2304, K_in) == k1.WIDE_LANES
    assert k1.slice_smem(32, 288, 1, 6) == (
        4 * (21 * 32 + 2 * 288 + 12 + 2 * k1.HT_SIZE) + 32 * 32)
    assert 1 < k1.slice_lanes(32, 4608, 5) < k1.SLICE_LANES
    Cm = 2304
    while k1.slice_smem(32, Cm, 1, 80) <= k1.SMEM_LIMIT:
        Cm += 64
    assert k1.slice_lanes(32, Cm - 64, 80) == k1.WIDE_LANES
    need = k1.slice_smem(32, Cm, 1, 80)
    with pytest.raises(NotImplementedError,
                       match=f"in-degree 80, Cm={Cm}, Nm=32 take {need} "
                             "bytes"):
        k1.slice_lanes(32, Cm, 80)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _jax_main(sys.argv[1])
