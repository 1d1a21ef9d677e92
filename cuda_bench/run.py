"""Run one cell of the benchmark of graphaligner_tpu_torch on the card.

    python3 cuda_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the set-up split, the window's calls
and each number compared beside its limit on standard error, and the
result as one JSON object, the last line of standard output. Exits with
another code than 0, printing no result, where CUDA is not available or
has fewer cards than the cell asks for, where the read pool runs out, and
where a module of JAX or of the JAX package is loaded once the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cuda_bench import bench

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = bench.load_cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = bench.measure(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
