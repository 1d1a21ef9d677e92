"""The port's multi-process runs and GAM shard merge against
graphaligner_tpu's (tests/test_multihost.py, test_component_shard.py and
test_stream_merge.py, on the port).

- Streaming GAM: ``PayloadStreamWriter`` writes the bytes of
  ``write_payloads``; ``iter_payloads_file`` yields the payloads of
  ``iter_messages`` (gzip members concatenated, raw framing, tiny chunks).
- The ordinal merge rebuilds one process's order when reads emit no
  message, and streams (its memory does not grow with the corpus).
- Two CLI processes over torch.distributed (gloo, a free local port) on
  sim at -b 35 with two reads without seeds inserted mid-corpus: the
  merged GAM equals the port's one-process bytes and the JAX package's.
- Component sharding on two disjoint copies of the sim graph, and on one
  component (one process gets every read, the other an empty shard): the
  merge equals one process of both packages.
- A worker that fails makes the others exit non-zero, not wait.
Tolerance zero: file bytes.
"""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

from graphaligner_tpu_torch.io import stream
from graphaligner_tpu_torch.parallel import distributed

FIX = pathlib.Path(__file__).parent / "fixtures"
SIM = FIX / "sim"
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(pathlib.Path(__file__).parent))


def _payloads(n, tag=b"p"):
    return [
        tag + str(i).encode() * ((i % 7) + 1) + b"x" * (i % 53) for i in range(n)
    ]


@pytest.mark.parametrize("n", [0, 3, 1000, 2345])
def test_payload_stream_writer_bytes_identical(tmp_path, n):
    pl = _payloads(n)
    a = str(tmp_path / "a.gam")
    b = str(tmp_path / "b.gam")
    stream.write_payloads(a, pl)
    w = stream.PayloadStreamWriter(b)
    for p in pl:
        w.write(p)
    assert w.close() == n
    assert open(a, "rb").read() == open(b, "rb").read()


def test_iter_payloads_file_matches_iter_messages(tmp_path):
    from graphaligner_tpu.io import stream as jax_stream

    pl = _payloads(2100)
    path = str(tmp_path / "x.gam")
    stream.write_payloads(path, pl)
    # a tiny chunk size drives every incremental path (varints and
    # payloads across chunk edges)
    assert list(stream.iter_payloads_file(path, chunk_size=37)) == pl
    two = str(tmp_path / "two.gam")
    data = open(path, "rb").read()
    with open(two, "wb") as f:
        f.write(data + data)  # two gzip members
    assert list(stream.iter_payloads_file(two, chunk_size=101)) == pl + pl
    assert list(stream.iter_messages(data + data)) == pl + pl
    assert stream._decompress_all(data + data) == jax_stream._decompress_all(
        data + data)
    assert stream._decompress_all(data) == stream.frame_payloads(pl)
    raw = str(tmp_path / "raw.bin")
    with open(raw, "wb") as f:
        f.write(stream.frame_payloads(pl))
    assert list(stream.iter_payloads_file(raw, chunk_size=64)) == pl
    # the JAX package's writer and reader agree byte for byte
    jpath = str(tmp_path / "j.gam")
    jax_stream.write_payloads(jpath, pl)
    assert open(jpath, "rb").read() == data
    assert list(jax_stream.iter_payloads_file(path, chunk_size=37)) == pl


def test_merge_shards_by_ordinal_with_missing_reads(tmp_path):
    pc, n_reads = 3, 11
    fails = {1, 4, 5, 9}  # reads that emit no message
    payload_of = {k: f"read{k}".encode() * 3 for k in range(n_reads)}
    out = str(tmp_path / "all.gam")
    for pi in range(pc):
        ordinals = [k for k in range(pi, n_reads, pc) if k not in fails]
        stream.write_payloads(
            distributed.shard_path(out, pi), [payload_of[k] for k in ordinals]
        )
        with open(distributed.ordinal_path(out, pi), "w") as f:
            f.write("".join(f"{k}\n" for k in ordinals))
    n = distributed.merge_shards(out, pc)
    expect = [payload_of[k] for k in range(n_reads) if k not in fails]
    assert n == len(expect)
    solo = str(tmp_path / "solo.gam")
    stream.write_payloads(solo, expect)
    assert open(out, "rb").read() == open(solo, "rb").read()


def test_shard_helpers_and_ordinal_names(tmp_path):
    from graphaligner_tpu.parallel import distributed as jax_dist
    from graphaligner_tpu_torch.io import vg

    reads = list(range(10))
    shards = [distributed.shard_reads_for_host(reads, i, 3) for i in range(3)]
    assert shards == [jax_dist.shard_reads_for_host(reads, i, 3)
                      for i in range(3)]
    out = str(tmp_path / "all.gam")
    assert distributed.shard_path(out, 2) == jax_dist.shard_path(out, 2)
    for i in range(3):
        distributed.write_host_shard(
            out, [vg.Alignment(name=f"r{i}_{j}") for j in range(2)], i
        )
    # no sidecars: the round-robin interleave
    assert distributed.merge_shards(out, 3) == 6
    names = [a.name for a in stream.read_messages(out, vg.Alignment)]
    assert names == ["r0_0", "r1_0", "r2_0", "r0_1", "r1_1", "r2_1"]

    class A:
        def __init__(self, name):
            self.name = name

    # shard of a 2-stride split: r0 r3 r6 r9, r3 emitted nothing
    path = distributed.write_shard_ordinals(
        out, 1, 2, ["r0", "r3", "r6", "r9"], [A("r0"), A("r6"), A("r9")]
    )
    assert open(path).read().split() == ["1", "5", "7"]
    with pytest.raises(RuntimeError, match="not found"):
        distributed.write_shard_ordinals(out, 1, 2, ["r0"], [A("r1")])


_RSS_SCRIPT = r"""
import resource, sys
sys.path.insert(0, sys.argv[1])
tmp = sys.argv[2]
from graphaligner_tpu_torch.io import stream
from graphaligner_tpu_torch.parallel import distributed

N, SZ = 40000, 1000  # 2 shards x 40 MB of payloads
out = tmp + "/big.gam"
for pi in range(2):
    w = stream.PayloadStreamWriter(distributed.shard_path(out, pi))
    with open(distributed.ordinal_path(out, pi), "w") as f:
        for j in range(N):
            w.write(("%08d" % (pi + 2 * j)).encode() * (SZ // 8))
            f.write(str(pi + 2 * j) + "\n")
    w.close()
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
n = distributed.merge_shards(out, 2)
assert n == 2 * N, n
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(base, peak)
"""


def test_merge_is_streaming_in_memory(tmp_path):
    """The merge's peak RSS growth stays far below the corpus (80 MB of
    payloads), and its bytes equal the one-shot writer's."""
    script = tmp_path / "rss.py"
    script.write_text(_RSS_SCRIPT)
    r = subprocess.run(
        [sys.executable, str(script), str(ROOT), str(tmp_path)],
        capture_output=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    base_kb, peak_kb = map(int, r.stdout.split())
    assert (peak_kb - base_kb) / 1024 < 25
    expect = [("%08d" % k).encode() * (1000 // 8) for k in range(2 * 40000)]
    one = str(tmp_path / "one.gam")
    stream.write_payloads(one, expect)
    assert open(tmp_path / "big.gam", "rb").read() == open(one, "rb").read()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _fastq_with_unseeded_reads(tmp_path):
    """sim's reads with two reads that have no seed hits inserted mid-
    corpus: they emit no message, so the merge must go by ordinal."""
    lines = (SIM / "sim.fastq").read_text().splitlines()
    recs = [lines[i : i + 4] for i in range(0, len(lines), 4)]
    noseed = ["@no_seed_read", "ACGT" * 40, "+", "!" * 160]
    recs = recs[:3] + [noseed] + recs[3:7] + [
        ["@no_seed_read2", "TTGCA" * 30, "+", "!" * 150]
    ] + recs[7:]
    fastq = tmp_path / "reads.fastq"
    fastq.write_text("\n".join("\n".join(r) for r in recs) + "\n")
    return fastq


def _cli_processes(tmp_path, argv_of, n=2, timeout=300):
    """Runs ``n`` port CLI processes of one group; returns [(rc, stderr)]."""
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = []
    for pid in range(n):
        work = tmp_path / f"p{pid}"
        work.mkdir(exist_ok=True)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "graphaligner_tpu_torch.runtime.cli",
             *argv_of(pid), "--backend", "cpu", "--coordinator", coord,
             "--num-processes", str(n), "--process-id", str(pid)],
            cwd=work, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
        ))
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            out.append((p.returncode, err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


_SOLO: dict = {}


def _solo_bytes(tmp_path, graph, fastq, seeds, tag):
    """One process of the port and of the JAX package: their GAM bytes
    (kept for the next test on the same inputs)."""
    key = (pathlib.Path(graph).read_bytes(), pathlib.Path(fastq).read_bytes(),
           pathlib.Path(seeds).read_bytes())
    if key not in _SOLO:
        _SOLO[key] = _run_solo(tmp_path, graph, fastq, seeds, tag)
    return _SOLO[key]


def _run_solo(tmp_path, graph, fastq, seeds, tag):
    from graphaligner_tpu.core.params import AlignerParams as JaxParams
    from graphaligner_tpu.runtime.aligner import align_reads as jax_align
    from graphaligner_tpu_torch.core.params import AlignerParams
    from graphaligner_tpu_torch.runtime.aligner import align_reads

    port = tmp_path / f"{tag}_port.gam"
    jax = tmp_path / f"{tag}_jax.gam"
    align_reads(
        AlignerParams(graph_file=str(graph), fastq_file=str(fastq),
                      alignment_file=str(port), seed_file=str(seeds),
                      initial_bandwidth=35),
        log=lambda *a: None, output_dir=str(tmp_path / f"{tag}_p"),
        backend="cpu",
    )
    jax_align(
        JaxParams(graph_file=str(graph), fastq_file=str(fastq),
                  alignment_file=str(jax), seed_file=str(seeds),
                  initial_bandwidth=35),
        log=lambda *a: None, output_dir=str(tmp_path / f"{tag}_j"),
        backend="jax",
    )
    return port.read_bytes(), jax.read_bytes()


def test_two_process_shard_align_merge(tmp_path, monkeypatch):
    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    fastq = _fastq_with_unseeded_reads(tmp_path)
    merged = tmp_path / "merged.gam"
    runs = _cli_processes(tmp_path, lambda pid: [
        "-g", str(SIM / "bubbles.vg"), "-f", str(fastq),
        "-s", str(SIM / "seeds.gam"), "-b", "35", "-a", str(merged)])
    for rc, err in runs:
        assert rc == 0, err[-3000:]
    port, jax = _solo_bytes(tmp_path, SIM / "bubbles.vg", fastq,
                            SIM / "seeds.gam", "solo")
    assert merged.read_bytes() == port == jax


def test_failed_worker_fails_the_run(tmp_path):
    """Process 1 cannot read its reads: it exits non-zero, and process 0
    fails at the barrier instead of waiting there."""
    merged = tmp_path / "merged.gam"
    runs = _cli_processes(tmp_path, lambda pid: [
        "-g", str(SIM / "bubbles.vg"),
        "-f", str(SIM / "sim.fastq") if pid == 0
        else str(tmp_path / "none.fastq"),
        "-s", str(SIM / "seeds.gam"), "-b", "35", "-a", str(merged)],
        timeout=120)
    assert runs[1][0] != 0 and "none.fastq" in runs[1][1]
    assert runs[0][0] != 0 and "barrier" in runs[0][1]
    assert not merged.exists()


def test_shard_plan_matches_jax(tmp_path):
    from graphaligner_tpu.parallel import components as jax_comp
    from graphaligner_tpu_torch.io import load_fastq
    from graphaligner_tpu_torch.parallel import components as comp
    from graphaligner_tpu_torch.runtime.aligner import load_seed_hits
    from test_component_shard import _two_component_fixture

    gpath, fpath, spath = _two_component_fixture(tmp_path)
    reads = load_fastq(fpath)
    seed_map = load_seed_hits(spath, [r.seq_id for r in reads])
    node_bp, edges = comp.graph_topology(gpath)
    assert (node_bp, edges) == jax_comp.graph_topology(gpath)
    uf, host_of_root = comp.shard_plan(node_bp, edges, seed_map, 2)
    juf, jhost = jax_comp.shard_plan(node_bp, edges, seed_map, 2)
    assert {n: host_of_root[uf.find(n)] for n in node_bp} == {
        n: jhost[juf.find(n)] for n in node_bp}
    assert sorted(set(host_of_root.values())) == [0, 1]
    g0, rh0 = comp.load_component_shard(gpath, seed_map, 0, 2)
    g1, _ = comp.load_component_shard(gpath, seed_map, 1, 2)
    full_nodes = len(node_bp) * 2 + 2  # both orientations, dummy pair
    assert g0.node_count + g1.node_count == full_nodes + 2
    some = next(n for n in seed_map if not n.endswith("_c2"))
    assert rh0(some) != rh0(some + "_c2")


@pytest.mark.parametrize("layout", ["two components", "one component"])
def test_component_sharded_two_hosts_byte_identical(tmp_path, layout,
                                                    monkeypatch):
    """Two hosts, each loading only its components, in one process in
    turn (host 1 first, so host 0's merge finds both shards; with no
    process group the barrier is a no-op). On one component host 1 gets
    no read and writes an empty shard."""
    from graphaligner_tpu_torch.core.params import AlignerParams
    from graphaligner_tpu_torch.runtime.aligner import align_reads
    from test_component_shard import _two_component_fixture

    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    if layout == "two components":
        gpath, fpath, spath = _two_component_fixture(tmp_path)
    else:
        gpath, fpath, spath = (str(SIM / "bubbles.vg"),
                               str(_fastq_with_unseeded_reads(tmp_path)),
                               str(SIM / "seeds.gam"))
    merged = tmp_path / "merged.gam"
    counts = {}
    for pidx in (1, 0):
        out = align_reads(
            AlignerParams(graph_file=gpath, fastq_file=fpath,
                          alignment_file=str(merged), seed_file=spath,
                          initial_bandwidth=35),
            log=lambda *a: None, output_dir=str(tmp_path / f"h{pidx}"),
            backend="cpu", process_index=pidx, process_count=2,
            shard_mode="components",
        )
        counts[pidx] = len(out)
    if layout == "one component":
        assert counts[1] == 0 and counts[0] == 20
    else:
        assert counts[0] == counts[1] == 8
    port, jax = _solo_bytes(tmp_path, gpath, fpath, spath, "solo")
    assert merged.read_bytes() == port == jax
