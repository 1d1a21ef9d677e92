"""The control of ``correct``: the reference put in the program's place, one
guarantee broken, must come out not correct.

    python3 cuda_bench/control.py --workload <cell> --seeds 1,2,3 [--calls 1]

The configuration states the band (``-b``) as well as exact alignments.
The control is the reference at an initial bandwidth one narrower, the
step a faster but wrong change would take. For each seed it makes the
cell's graph and read pool as a run does (the reads drawn on the card
where there is one, as the runs draw them), takes the sample a run's
check takes from the reads of ``--calls`` calls, and prints the numbers
``check.compare`` gives the control's answers, as one JSON line a seed.
It runs on the host alone; no run of the benchmark runs it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, calls: int, device: str,
             band_delta: int = -1) -> dict:
    from cuda_bench import check
    from cuda_bench.bench import POOL
    from cuda_bench.gen import graph_generator
    from cuda_bench.gen.reads import ReadMaker, stream_seed

    cfg, traffic = cell.config, cell.traffic
    sg = graph_generator(cfg["generator"]).build(cfg["graph"],
                                                 stream_seed(seed, 0))
    n = calls * int(cfg["aligner"]["device_batch"])
    reads = ReadMaker(sg, traffic, device).reads(n, seed, POOL, "read")
    picked = set(check.sample([r[0] for r in reads],
                              int(traffic["check_reads"]), seed))
    sampled = [r for r in reads if r[0] in picked]
    want = check.reference_answers(sg.handed, sampled, cfg["aligner"])
    ctrl = check.reference_answers(sg.handed, sampled, cfg["aligner"],
                                   band_delta)
    got = {name: (a.failed, a.payload, a.cells) for name, a in ctrl.items()}
    return check.compare(got, sampled, want)


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from cuda_bench import bench

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = bench.load_cell(spec, args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = readings(cell, seed, args.calls, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers, "device": device,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
