"""Aligning a read file end to end (reference Aligner.cpp), torch port.

Port of ``graphaligner_tpu/runtime/aligner.py``: seeded banded mode
through the batched engine (``core.batch_align``), and exhaustive mode
(-i, no seed file) through the batched exhaustive engine (``core.engine``).
Reads are aligned in chunks; per-read GAM and trace files and the final
concatenated GAM are written exactly as the JAX package writes them.

``backend="oracle"`` aligns read by read on the host through the scalar
oracle (``core.align.align_one_way_seeded`` / ``align_one_way_full_band``),
as the JAX package's ``--backend oracle`` does; it needs no device. It
runs only when asked for: a ``NotImplementedError`` of the device paths
(one of the port's named limits, such as the long walk past in-degree 4
or a launch whose tables pass a block's shared memory) propagates, its
message naming ``--backend oracle``, and nothing is realigned on the host
(the JAX package realigns the run after any exception).

``mesh_axis="dp"`` splits every scan round's lanes over a device mesh
(``parallel.mesh``; the seeded path only, as in the JAX package). With
``process_count`` > 1 each process aligns its share of the reads (strided,
or by the connected components of their seeds with ``shard_mode=
"components"``) into a GAM shard with a sidecar of global read ordinals,
and process 0 merges the shards after a barrier (``parallel.distributed``).
"""

from __future__ import annotations

import os
import sys
import traceback
from dataclasses import replace

from .._device import get_device
from ..core.align import align_one_way_full_band, align_one_way_seeded
from ..core.params import AlignerParams
from ..core.result import INT32_MAX
from ..graph.bigraph import load_alignment_graph
from ..io import load_fastq, stream, vg
from ..utils import trace

# copied from graphaligner_tpu/runtime/aligner.py:28-85 --------------------
def replace_digraph_node_ids(alignment: vg.Alignment) -> None:
    for m in alignment.path.mapping:
        m.position.node_id //= 2


def write_trace(trace, path: str) -> None:
    """Trace file format of the reference's writeTrace (Aligner.cpp:93-100):
    nodeID offset reverse readpos type graphChar readChar."""
    with open(path, "w") as f:
        for t in trace:
            f.write(
                f"{t.node_id} {t.offset} {1 if t.reverse else 0} {t.readpos} "
                f"{int(t.type)} {t.graph_char} {t.read_char}\n"
            )


def _finalize_output_alignment(alignment):
    """Digraph->bigraph id mapping + wire encoding of one result.

    LazyAlignment results (the batched pipeline) encode through the
    native C++ serializer with the id division fused (~100x the Python
    object+encode path); everything else takes the object path
    (replace ids in place, byte-identical either way). Traced as span
    ``finalize.gam`` and counter ``finalize.reads`` (``utils.trace``)."""
    from ..core.result import LazyAlignment, PayloadAlignment
    from ..io import native

    trace.count("finalize.reads")
    with trace.span("finalize.gam"):
        if isinstance(alignment, LazyAlignment) and alignment._obj is None:
            payloads = native.encode_alignments(
                [alignment.name],
                [alignment.sequence],
                [alignment.score],
                [alignment.query_position],
                [alignment._runs],
                div2=True,
            )
            if payloads is not None:
                return PayloadAlignment(payloads[0], name=alignment.name)
        replace_digraph_node_ids(alignment)
        return alignment


def _safe_filename(name: str) -> str:
    return name.replace("/", "_").replace(":", "_")


def load_seed_hits(seed_file: str, read_names) -> dict:
    """read name → [(node id, query position, is_reverse)]
    (reference Aligner.cpp:245-273)."""
    seeds: dict = {}
    for a in stream.read_messages(seed_file, vg.Alignment):
        seeds.setdefault(a.name, []).append(
            (
                a.path.mapping[0].position.node_id,
                a.query_position,
                a.path.mapping[0].position.is_reverse,
            )
        )
    return {name: seeds.get(name, []) for name in read_names}


# --------------------------------------------------------------------------
def align_reads(
    params: AlignerParams,
    log=print,
    output_dir: str = ".",
    backend: str = "cuda",
    device_batch: int = 4096,
    mesh_axis: str = "none",
    process_index: int | None = None,
    process_count: int | None = None,
    shard_mode: str = "reads",
) -> list:
    """Align all reads on ``backend`` ("cuda", "cpu" for the kernels'
    plain versions, or "oracle" for the per-read host path); returns the
    list of this process's output alignments.

    mesh_axis "dp" runs the seeded path on a mesh of every visible card
    (of the one CPU device for backend "cpu"). With
    process_count > 1 (``parallel.distributed.initialize`` gives it), this
    process aligns its shard into ``<alignment file>.shard<i>`` and process
    0 merges every shard into the alignment file, byte-identical to one
    process's (JAX runtime/aligner.py:88-219)."""
    shard_info: dict = {}
    out = _align_reads_impl(
        params, log, output_dir, backend, device_batch, mesh_axis,
        process_index, process_count, shard_mode, shard_info,
    )
    if process_count is not None and process_count > 1:
        from ..parallel import distributed as _dist

        if params.alignment_file:
            # ordinal sidecar: reads with no seeds / failed alignments emit
            # no message, so the merge orders by global read ordinal, not by
            # shard position
            _dist.write_shard_ordinals(
                params.alignment_file,
                process_index,
                process_count,
                shard_info.get("ids", []),
                out,
                ordinals=shard_info.get("ordinals"),
            )
        _dist.barrier()
        if process_index == 0 and params.alignment_file:
            n = _dist.merge_shards(params.alignment_file, process_count)
            log(f"merged {n} alignments from {process_count} host shards")
    return out


def _align_reads_impl(params, log, output_dir, backend, device_batch,
                      mesh_axis, process_index, process_count, shard_mode,
                      shard_info) -> list:
    # the per-read host path takes no device and no mesh, as in the JAX
    # package
    oracle = backend == "oracle"
    device = None if oracle else get_device(backend)
    mesh = None
    if not oracle and mesh_axis and mesh_axis != "none":
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(axis=mesh_axis,
                         devices=[device] if device.type == "cpu" else None)
    os.makedirs(output_dir, exist_ok=True)
    dist = process_count is not None and process_count > 1
    fastqs = load_fastq(params.fastq_file)
    graph = None
    if dist:
        # each process aligns its read shard into a GAM shard of its own;
        # process 0 merges them after the barrier (Aligner.cpp:276-314)
        from ..parallel import distributed as _dist

        if params.alignment_file:
            params = replace(
                params,
                alignment_file=_dist.shard_path(params.alignment_file,
                                                process_index),
            )
        # stride over the TRAVERSAL order (back to front, the reference's
        # shared stack) so that the ordinal merge rebuilds one process's
        # output order byte for byte
        traversal = list(reversed(fastqs))
        if shard_mode == "components":
            # each process loads only ITS connected components and aligns
            # the reads whose seeds lie there (parallel.components)
            if not params.seed_file:
                raise ValueError("--shard components requires a seed file (-s)")
            from ..parallel import components as _comp

            all_seeds = load_seed_hits(
                params.seed_file, [f.seq_id for f in traversal]
            )
            graph, read_host = _comp.load_component_shard(
                params.graph_file, all_seeds, process_index, process_count
            )
            pairs = [
                (j, f)
                for j, f in enumerate(traversal)
                if read_host(f.seq_id) == process_index
            ]
            shard = [f for _, f in pairs]
            ordinals = [j for j, _ in pairs]
        else:
            shard = _dist.shard_reads_for_host(
                traversal, process_index, process_count
            )
            ordinals = list(range(process_index, len(traversal), process_count))
        # shard read ids in traversal order and their global ordinals, for
        # the ordinal sidecar
        shard_info["ids"] = [f.seq_id for f in shard]
        shard_info["ordinals"] = ordinals
        fastqs = list(reversed(shard))
        log(f"process {process_index}/{process_count}: {len(fastqs)} reads")
    log(f"{len(fastqs)} reads")
    seed_hits = None
    if params.seed_file:
        seed_hits = load_seed_hits(params.seed_file, [f.seq_id for f in fastqs])
    if graph is None:
        log(f"load graph from {params.graph_file}")
        graph = load_alignment_graph(params.graph_file)
    s = graph.stats
    log(f"{s.nodes} nodes\n{s.bp}bp\n{s.edges} edges\n"
        f"{s.high_in_degree_nodes} nodes with in-degree >= 2")
    if oracle:
        alignments = _align_reads_per_read(params, graph, fastqs, seed_hits,
                                           log, output_dir)
    else:
        try:
            if seed_hits is None:
                alignments = _align_reads_batched(
                    graph, fastqs, log, output_dir, device_batch, device
                )
            else:
                alignments = _align_reads_seeded_batched(
                    params, graph, fastqs, seed_hits, log, output_dir,
                    device_batch, device, mesh,
                )
        except NotImplementedError as e:
            # a named limit of the device path: the host path is the
            # caller's choice, never a silent one
            raise NotImplementedError(
                f"{e}; --backend oracle aligns these reads on the host, one "
                "at a time"
            ) from e
    log(f"final result has {len(alignments)} alignments")
    if params.alignment_file:
        stream.write_messages(params.alignment_file, alignments)
    if params.auggraph_file:
        graphs = stream.read_messages(params.graph_file, vg.Graph)
        # reference quirk: with -a also given, the augmented graph is built
        # from an EMPTY list (Aligner.cpp:310-321)
        aug_input = [] if params.alignment_file else alignments
        aug = augment_graph_with_alignments(graphs, aug_input)
        stream.write_messages(params.auggraph_file, [aug])
    return alignments


def _write_read(fastq, aln, trace, output_dir) -> None:
    name = _safe_filename(fastq.seq_id)
    stream.write_messages(
        os.path.join(output_dir, f"alignment_0_{name}.gam"), [aln]
    )
    write_trace(trace, os.path.join(output_dir, f"trace_0_{name}.trace"))


def _align_reads_per_read(params, graph, fastqs, seed_hits, log,
                          output_dir) -> list:
    """The per-read host loop (JAX runtime/aligner.py:257-331): reads
    popped from the back, each through the scalar oracle, a failure
    failing only its read."""
    from ..io import native

    alignments: list = []
    queue = list(fastqs)
    while queue:
        fastq = queue.pop()  # back-first, like the reference's shared stack
        log(f"thread 0 {len(queue)} left")
        log(f"read {fastq.seq_id} size {len(fastq.sequence)}bp")
        # native crash attribution (reference assertSetRead,
        # Aligner.cpp:121): a SIGSEGV inside a native call names this read
        # and fails only it
        native.set_read(fastq.seq_id)
        try:
            if seed_hits is None:
                result = align_one_way_full_band(
                    graph, fastq.seq_id, fastq.sequence,
                    params.initial_bandwidth, params.ramp_bandwidth,
                )
            else:
                if not seed_hits.get(fastq.seq_id):
                    log(f"read {fastq.seq_id} has no seed hits")
                    log(f"read {fastq.seq_id} alignment failed")
                    continue
                result = align_one_way_seeded(
                    graph, fastq.seq_id, fastq.sequence,
                    params.initial_bandwidth, params.ramp_bandwidth,
                    seed_hits[fastq.seq_id], logger=log,
                )
        except Exception:
            log(f"read {fastq.seq_id} alignment failed (exception!)")
            traceback.print_exc(file=sys.stderr)
            continue
        log(f"read {fastq.seq_id} took {result.elapsed_milliseconds}ms")
        if result.alignment_failed or result.alignment.score == INT32_MAX:
            log(f"read {fastq.seq_id} alignment failed")
            continue
        log(f"read {fastq.seq_id} score {result.alignment.score}")
        if result.alignment.score > len(fastq.sequence) * 0.25:
            log(f"read {fastq.seq_id} score is poor: {result.alignment.score}")
        log(
            f"read {fastq.seq_id} alignment positions: "
            f"{result.alignment_start}-{result.alignment_end} "
            f"(read {len(fastq.sequence)}bp)"
        )
        replace_digraph_node_ids(result.alignment)
        alignments.append(result.alignment)
        _write_read(fastq, result.alignment, result.trace, output_dir)
    return alignments


def _align_reads_seeded_batched(params, graph, fastqs, seed_hits, log,
                                output_dir, device_batch, device,
                                mesh=None) -> list:
    """``mesh`` splits every scan round's lanes over its devices (the
    multi-card analogue of the reference's thread pool,
    Aligner.cpp:275-314)."""
    from ..core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
        set_host_threads,
    )

    if params.num_threads and params.num_threads > 1:
        set_host_threads(params.num_threads)
    if mesh is not None:
        log(f"device mesh: {mesh.size} devices along '{mesh.axis}'")
        aligner = BandedBatchAligner(
            graph, params.initial_bandwidth, params.ramp_bandwidth,
            mesh=mesh, mesh_axis=mesh.axis,
        )
    else:
        aligner = BandedBatchAligner(
            graph, params.initial_bandwidth, params.ramp_bandwidth, device
        )
    alignments: list = []
    order = list(reversed(fastqs))  # the reference's back-first order
    for start in range(0, len(order), device_batch):
        chunk = order[start : start + device_batch]
        with_seeds = [r for r in chunk if seed_hits.get(r.seq_id)]
        for r in chunk:
            if not seed_hits.get(r.seq_id):
                log(f"read {r.seq_id} has no seed hits")
                log(f"read {r.seq_id} alignment failed")
        results = align_reads_seeded_batch(graph, aligner, with_seeds, seed_hits)
        for fastq in with_seeds:
            result = results[fastq.seq_id]
            log(f"read {fastq.seq_id} size {len(fastq.sequence)}bp")
            if result.alignment_failed or result.alignment.score == INT32_MAX:
                log(f"read {fastq.seq_id} alignment failed")
                continue
            log(f"read {fastq.seq_id} score {result.alignment.score}")
            if result.alignment.score > len(fastq.sequence) * 0.25:
                log(f"read {fastq.seq_id} score is poor: {result.alignment.score}")
            log(
                f"successfully aligned read {fastq.seq_id} with "
                f"{result.cells_processed} cells"
            )
            aln = _finalize_output_alignment(result.alignment)
            alignments.append(aln)
            _write_read(fastq, aln, result.trace, output_dir)
    return alignments


def _align_reads_batched(graph, fastqs, log, output_dir, device_batch,
                         device) -> list:
    """Full-band (-i) alignment through the batched exhaustive engine,
    processed in chunks of at most ``device_batch`` reads, as many as the
    free memory holds at the longest read's slice count (JAX
    runtime/aligner.py:410-447)."""
    from ..core.engine import BatchAligner, align_batch_full_band
    from ..core.params import WORD_SIZE

    ba = BatchAligner(graph, device)
    alignments: list = []
    order = list(reversed(fastqs))  # the reference's back-first order
    if not order:
        return alignments
    slices = max((len(r.sequence) + WORD_SIZE - 1) // WORD_SIZE for r in order)
    lanes = ba.lanes_that_fit(slices, device_batch)
    for start in range(0, len(order), lanes):
        chunk = order[start : start + lanes]
        results = align_batch_full_band(graph, chunk, batch_aligner=ba)
        for fastq, result in zip(chunk, results):
            log(f"read {fastq.seq_id} size {len(fastq.sequence)}bp")
            if result.alignment_failed or result.alignment.score == INT32_MAX:
                log(f"read {fastq.seq_id} alignment failed")
                continue
            log(f"read {fastq.seq_id} score {result.alignment.score}")
            replace_digraph_node_ids(result.alignment)
            alignments.append(result.alignment)
            _write_read(fastq, result.alignment, result.trace, output_dir)
    return alignments


# copied from graphaligner_tpu/runtime/aligner.py:450-471 ------------------
def augment_graph_with_alignments(graphs: list, alignments: list) -> vg.Graph:
    """Embed alignment-path edges into the graph
    (reference augmentGraphwithAlignment, Aligner.cpp:24-74)."""
    aug = vg.Graph()
    for g in graphs:
        for node in g.node:
            aug.node.append(
                vg.Node(id=node.id, sequence=node.sequence, name=node.name)
            )
    for aln in alignments:
        maps = aln.path.mapping
        for i in range(len(maps) - 1):
            aug.edge.append(
                vg.Edge(
                    from_=maps[i].position.node_id,
                    to=maps[i + 1].position.node_id,
                    from_start=maps[i].position.is_reverse,
                    to_end=maps[i + 1].position.is_reverse,
                    overlap=0,
                )
            )
    return aug
