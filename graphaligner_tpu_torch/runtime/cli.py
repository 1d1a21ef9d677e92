"""CLI with the reference Aligner's flags (AlignerMain.cpp:31-96).

    python -m graphaligner_tpu_torch.runtime.cli -g graph.vg -f reads.fastq
        -a out.gam -t N -b band [-B rampband] (-s seeds.gam | -i)
        [-A auggraph.vg] [--backend cuda|cpu|oracle] [--mesh dp]
        [--coordinator host:port --num-processes N --process-id I
         [--shard reads|components]]

Seeded banded mode (-s) and exhaustive mode (-i, which ignores -s, as
graphaligner_tpu's CLI does). --backend oracle aligns read by read on the
host (the JAX package's --backend oracle) and takes no --mesh. --mesh dp
splits the seeded path's scan rounds over every visible card;
--coordinator starts one process of a multi-process run (one per host,
or one per card with CUDA_VISIBLE_DEVICES), whose GAM shards process 0 merges into -a.
"""

from __future__ import annotations

import argparse
import sys

from ..core.params import AlignerParams
from .aligner import align_reads


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graphaligner-torch",
        description="sequence-to-graph aligner on PyTorch + CUDA",
    )
    p.add_argument("-g", dest="graph_file", required=True, help="graph (.vg or .gfa)")
    p.add_argument("-f", dest="fastq_file", required=True, help="reads (.fastq/.fa)")
    p.add_argument("-a", dest="alignment_file", default="", help="output GAM")
    p.add_argument("-t", dest="num_threads", type=int, default=1)
    p.add_argument("-b", dest="initial_bandwidth", type=int, default=0)
    p.add_argument("-B", dest="ramp_bandwidth", type=int, default=0)
    p.add_argument("-A", dest="auggraph_file", default="", help="augmented graph out")
    p.add_argument("-i", dest="initial_full_band", action="store_true")
    p.add_argument("-s", dest="seed_file", default="", help="seed GAM")
    p.add_argument("-d", dest="dynamic_row_start", type=int, default=64)
    p.add_argument(
        "--backend",
        default="cuda",
        choices=["cuda", "cpu", "oracle"],
        help="cuda (default) runs the CUDA kernels and fails without a "
        "card; cpu runs their plain torch versions; oracle is the scalar "
        "host pipeline of the JAX package's --backend oracle, one read at "
        "a time, with no device",
    )
    p.add_argument(
        "--coordinator",
        default="",
        help="multi-process: host:port of process 0's rendezvous "
        "(torch.distributed, gloo)",
    )
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)
    p.add_argument(
        "--shard",
        default="reads",
        choices=["reads", "components"],
        help="multi-process sharding: reads = strided read split, graph "
        "replicated per process; components = connected-component graph "
        "partition, reads routed by seed component (requires -s)",
    )
    p.add_argument(
        "--mesh",
        default="none",
        choices=["none", "dp"],
        help="split the seeded path's scan rounds data-parallel over every "
        "visible card (one CPU device with --backend cpu; --backend oracle "
        "takes no mesh)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.dynamic_row_start % 64 != 0:
        print("dynamic row start has to be a multiple of 64", file=sys.stderr)
        return 1
    if args.num_threads < 1:
        print("number of threads must be >= 1", file=sys.stderr)
        return 1
    if args.initial_bandwidth < 2:
        print("bandwidth must be >= 2", file=sys.stderr)
        return 1
    if args.ramp_bandwidth != 0 and args.ramp_bandwidth <= args.initial_bandwidth:
        print("backup bandwidth must be higher than initial bandwidth", file=sys.stderr)
        return 1
    if not args.initial_full_band and not args.seed_file:
        print("either initial full band or seed file must be set", file=sys.stderr)
        return 1
    params = AlignerParams(
        graph_file=args.graph_file,
        fastq_file=args.fastq_file,
        alignment_file=args.alignment_file,
        auggraph_file=args.auggraph_file,
        seed_file="" if args.initial_full_band else args.seed_file,
        num_threads=args.num_threads,
        initial_bandwidth=args.initial_bandwidth,
        ramp_bandwidth=args.ramp_bandwidth,
        dynamic_row_start=args.dynamic_row_start,
        initial_full_band=args.initial_full_band,
    )
    pidx = pcount = None
    if args.coordinator:
        from ..parallel import distributed

        pidx, pcount = distributed.initialize(
            args.coordinator, args.num_processes, args.process_id
        )
    try:
        align_reads(
            params,
            backend=args.backend,
            mesh_axis=args.mesh,
            process_index=pidx,
            process_count=pcount,
            shard_mode=args.shard,
        )
    finally:
        if args.coordinator:
            distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
