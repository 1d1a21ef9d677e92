"""A tiny cell of each configuration, small enough for the CPU's plain
versions of the kernels: a few reads of a few hundred bases a call."""

import json
from pathlib import Path

from cuda_bench import bench

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SIZES = {"chr20_1kg_af05": 20_000}
TRAFFIC = {"read_len": {"min": 300, "max": 420},
           "errors": {"sub": 0.01, "ins": 0.005, "del": 0.005,
                      "ins_base": "repeat"},
           "seed": {"at": "uniform", "strand": "both"},
           "pool_reads": 12, "warmup_reads": 2, "check_reads": 4}


def tiny_cell(config: str = "chr20_1kg_af05", device_batch: int = 4,
              **traffic) -> bench.Cell:
    cfg = json.loads((CONFIGS / f"{config}.json").read_text())
    cfg["graph"]["ref_length"] = SIZES[config]
    cfg["aligner"]["device_batch"] = device_batch
    spec = json.loads((CONFIGS.parents[1] / "BENCHMARK.json").read_text())
    work = next(w["name"] for w in spec["workloads"] if w["config"] == config)
    full = bench.load_cell(spec, work)
    return bench.Cell(f"{config}.tiny", cfg, dict(TRAFFIC, **traffic), 1,
                      full.metrics, full.traced)
