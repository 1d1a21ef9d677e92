# Port of graphaligner_tpu/parallel/distributed.py: torch.distributed (gloo) in place of jax.distributed; the shard helpers and the merge are copies.
"""Multi-process orchestration: process-group bring-up, per-process read
sharding, and GAM shard merging.

Each process (one per host, or one per card with ``CUDA_VISIBLE_DEVICES``)
aligns its share of the reads on its own device with a replicated graph
index (or, with ``--shard components``, only the connected components its
reads' seeds name), writes a GAM shard with a sidecar of global read
ordinals, and process 0 stream-merges the shards after a barrier: the
analogue of the reference's per-thread result vectors + final concat
(Aligner.cpp:276-314). The device work needs no collectives; the process
group (``gloo``, host TCP) carries only the barrier before the merge.
"""

from __future__ import annotations

import datetime
import os

from ..io import stream

# how long a process waits for the others at the barrier (and at the
# group's rendezvous): past it, or as soon as a peer's connection drops,
# the wait raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=30)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple:
    """Join the process group at ``coordinator_address`` (host:port, served
    by process 0) over gloo; a no-op without a coordinator.

    Returns (process_index, process_count)."""
    import torch.distributed as dist

    if not coordinator_address:
        return 0, 1
    if not num_processes or num_processes < 1:
        raise ValueError("--coordinator needs --num-processes >= 1")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(
            f"--process-id must be in [0, {num_processes}), got {process_id}"
        )
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=TIMEOUT,
    )
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Leave the process group (no-op when none was joined)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Block until every process reaches this point (process 0 must not
    merge before the others finish writing their shards). No-op for
    single-process runs; raises when a peer is gone or the group's timeout
    passes."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return
    dist.barrier()


# copied from graphaligner_tpu/parallel/distributed.py:45-59 ---------------
def shard_reads_for_host(reads: list, process_index: int, process_count: int) -> list:
    """Strided split of the read set across hosts — deterministic, no
    coordination needed (every host computes its own shard)."""
    return reads[process_index::process_count]


def shard_path(alignment_file: str, process_index: int) -> str:
    root, ext = os.path.splitext(alignment_file)
    return f"{root}.shard{process_index}{ext}"


def write_host_shard(alignment_file: str, alignments: list, process_index: int) -> str:
    path = shard_path(alignment_file, process_index)
    stream.write_messages(path, alignments)
    return path


# copied from graphaligner_tpu/parallel/distributed.py:75-166 --------------
def ordinal_path(alignment_file: str, process_index: int) -> str:
    return shard_path(alignment_file, process_index) + ".ord"


def write_shard_ordinals(
    alignment_file: str,
    process_index: int,
    process_count: int,
    shard_read_ids: list,
    alignments: list,
    ordinals: list | None = None,
) -> str:
    """Sidecar of GLOBAL traversal ordinals, one per shard message.

    Reads with no seed hits or a failed alignment emit NO message
    (Aligner.cpp:124-148 analog), so a positional round-robin interleave
    cannot reconstruct the single-process output order — the merge
    k-way-merges payloads by these ordinals instead. Alignments are
    produced in shard traversal order, so matching names in order
    recovers each message's shard position j; the global ordinal is
    ordinals[j] when the caller routed reads explicitly (component
    sharding), else process_index + j * process_count (strided split)."""
    path = ordinal_path(alignment_file, process_index)
    j = 0
    lines = []
    for a in alignments:
        name = a.name
        while j < len(shard_read_ids) and shard_read_ids[j] != name:
            j += 1
        if j >= len(shard_read_ids):
            raise RuntimeError(
                f"alignment {name!r} not found in shard read order"
            )
        lines.append(
            str(
                ordinals[j]
                if ordinals is not None
                else process_index + j * process_count
            )
        )
        j += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return path


def merge_shards(alignment_file: str, process_count: int) -> int:
    """Merge per-host GAM shards into the final file (host 0, after
    barrier()) as a STREAM: raw message payloads are k-way merged by
    global read ordinal (see write_shard_ordinals) without protobuf
    decode/encode, reading each shard incrementally and compressing the
    output incrementally — peak memory is O(process_count), not corpus
    size, and the merged bytes equal a single-process run's output
    exactly. Returns the alignment count.

    Shards written without ordinal sidecars (direct write_host_shard
    users) fall back to a round-robin interleave, which is only correct
    when every read emitted exactly one message."""
    import heapq

    have_ord = all(
        os.path.exists(ordinal_path(alignment_file, i))
        for i in range(process_count)
    )
    if not have_ord:
        per_shard = []
        for i in range(process_count):
            with open(shard_path(alignment_file, i), "rb") as f:
                per_shard.append(list(stream.iter_messages(f.read())))
        merged = []
        for j in range(max(len(s) for s in per_shard) if per_shard else 0):
            for s in per_shard:
                if j < len(s):
                    merged.append(s[j])
        stream.write_payloads(alignment_file, merged)
        return len(merged)

    def shard_stream(i):
        with open(ordinal_path(alignment_file, i)) as of:
            for line, payload in zip(
                of, stream.iter_payloads_file(shard_path(alignment_file, i))
            ):
                yield int(line), payload

    n = 0
    with stream.PayloadStreamWriter(alignment_file) as w:
        for _, payload in heapq.merge(
            *[shard_stream(i) for i in range(process_count)]
        ):
            w.write(payload)
            n += 1
    return n
