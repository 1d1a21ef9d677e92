"""The system under test: graphaligner_tpu_torch, driven as its CLI drives
it (``runtime/aligner.py::_align_reads_seeded_batched``): one
``BandedBatchAligner`` a run, ``align_reads_seeded_batch`` a call of a
chunk of reads, then each read's finalize and GAM encode
(``_finalize_output_alignment``), kept in memory.

This is the only module of the benchmark that imports the program.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# the seeded kernels' sources (graphaligner_tpu_torch/csrc/<name>.cu)
KERNELS = ("banded_cell", "walk_moves", "project_band")


def configure(threads: int) -> None:
    """No read may fall silently to the host oracle, and the host works
    with ``threads`` threads (the CLI's -t): the native tie replay and
    decoder's, and torch's own on the CPU."""
    from graphaligner_tpu_torch.core import batch_align

    os.environ["GA_NO_FALLBACK"] = "1"
    batch_align.set_host_threads(threads)
    torch.set_num_threads(threads)


def load_extensions(device: torch.device) -> None:
    """The native host library, and on the card the kernels' libraries
    (built on the first run in a checkout, loaded after)."""
    from graphaligner_tpu_torch.io import native

    native.get_lib()
    if device.type == "cuda":
        from graphaligner_tpu_torch.ops import _build

        for name in KERNELS:
            _build.library(name)


def load_graph(handed: dict):
    """The program's graph from the digraph's arrays the benchmark hands
    it."""
    from graphaligner_tpu_torch.graph.alignment_graph import AlignmentGraph

    return AlignmentGraph.from_arrays(*handed["arrays"])


def make_aligner(graph, aligner: dict, device: torch.device, stages: dict):
    """The run's aligner, its graph tables, reach table and device tables
    timed into ``stages`` (seconds by stage)."""
    from graphaligner_tpu_torch.core import batch_align, trace_ops

    wrapped = {
        (batch_align, "build_graph_tables"): "tables",
        (batch_align, "ensure_reach"): "reach",
        (batch_align, "device_tables"): "device_tables",
        (trace_ops, "build_reverse_pos"): "device_tables",
    }
    saved = {}

    def timer(fn, stage):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                stages[stage] = stages.get(stage, 0.0) + time.perf_counter() - t0
        return call

    for (mod, name), stage in wrapped.items():
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, timer(saved[(mod, name)], stage))
    try:
        return batch_align.BandedBatchAligner(
            graph, int(aligner["initial_bandwidth"]),
            int(aligner["ramp_bandwidth"]), device)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def align_call(graph, aligner, reads, finalize_span=contextlib.nullcontext):
    """One call of the CLI's chunk: reads [(name, sequence, (node id,
    read position, reverse))], one seed a read as a seed file gives it ->
    {name: (failed, GAM bytes or None, cells_processed)}. A read the
    program returns nothing for is absent."""
    from graphaligner_tpu_torch.core.batch_align import align_reads_seeded_batch
    from graphaligner_tpu_torch.core.result import INT32_MAX
    from graphaligner_tpu_torch.io.fastq import FastQ
    from graphaligner_tpu_torch.runtime.aligner import _finalize_output_alignment

    fastqs = [FastQ(name, seq, "") for name, seq, _ in reads]
    seeds = {name: [seed] for name, _, seed in reads}
    results = align_reads_seeded_batch(graph, aligner, fastqs, seeds)
    out = {}
    with finalize_span():
        for fq in fastqs:
            res = results.get(fq.seq_id)
            if res is None:
                continue
            if res.alignment_failed or res.alignment.score == INT32_MAX:
                out[fq.seq_id] = (True, None, int(res.cells_processed))
                continue
            aln = _finalize_output_alignment(res.alignment)
            out[fq.seq_id] = (False, aln.encode(), int(res.cells_processed))
    return out


def launches() -> int:
    """Fused K1 launches so far, both routes: one a slice."""
    from graphaligner_tpu_torch.ops import banded_cell

    return banded_cell.LAUNCHES + banded_cell.LAUNCHES_WIDE


def traced_methods():
    """(owner, attribute, span name, counts the trace it is given) of each
    call the traced run wraps in a span."""
    from graphaligner_tpu_torch.core.batch_align import BandedBatchAligner
    from graphaligner_tpu_torch.io import native

    return [
        (BandedBatchAligner, "_run", "scan", False),
        (BandedBatchAligner, "_walk", "walk", False),
        (native.TracePieceCtx, "piece", "finalize.piece", True),
    ]
