"""How ``correct`` is decided: the window's answers against the plain
reference (``reference/``), read by read.

Every read of the window's calls must have an answer. A sample of them,
drawn from the run's seed, is aligned again by the reference, from the
graph it builds itself out of what the benchmark handed to both sides,
once the window has closed and the program's state is freed. A sampled
read's answer must say what the reference says: failed or not, the same
GAM message byte for byte and, where aligned, the same band cell count.
Each comparison is exact, so each limit is 0.
"""

from __future__ import annotations

import sys
import time

import numpy as np

LIMITS = {"missing_reads": 0, "gam_mismatch": 0, "cells_mismatch": 0}


def sample(names: list, k: int, seed: int) -> list:
    """k of the names (all of them, if fewer), drawn from the seed."""
    rng = np.random.default_rng([seed % 2**64, 3])
    idx = rng.choice(len(names), size=min(k, len(names)), replace=False)
    return [names[i] for i in sorted(idx)]


def reference_answers(handed, reads, aligner: dict, band_delta: int = 0):
    """{name: reference.seeded.Answer} of reads [(name, seq, seed)],
    the reference at the configuration's bandwidths (plus ``band_delta``
    on the initial one: the control's narrower band)."""
    from .reference import seeded

    graph = seeded.load_graph(handed)
    b = int(aligner["initial_bandwidth"]) + band_delta
    B = int(aligner["ramp_bandwidth"])
    return {name: seeded.align(graph, name, seq, [seed], b, B)
            for name, seq, seed in reads}


def compare(answers: dict, reads: list, want: dict) -> dict:
    """The numbers compared: ``answers`` {name: (failed, payload, cells)}
    of the window's ``reads`` against ``want`` {name: Answer} of a sample
    of them."""
    missing = sum(1 for name, _, _ in reads if name not in answers)
    gam = cells = 0
    for name, ref in want.items():
        got = answers.get(name)
        if got is None or got[0] != ref.failed or (
                not ref.failed and got[1] != ref.payload):
            gam += 1
        elif not ref.failed and got[2] != ref.cells:
            cells += 1
    return {"missing_reads": missing, "gam_mismatch": gam,
            "cells_mismatch": cells}


def check(answers, reads, handed, aligner, k, seed):
    """(correct, {number: {"value", "limit"}}, sampled, seconds)."""
    t0 = time.perf_counter()
    picked = set(sample([name for name, _, _ in reads], k, seed))
    want = reference_answers(handed, [r for r in reads if r[0] in picked],
                             aligner)
    got = compare(answers, reads, want)
    numbers = {n: {"value": v, "limit": LIMITS[n]} for n, v in got.items()}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    return correct, numbers, len(want), time.perf_counter() - t0


def print_numbers(numbers: dict) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for n, v in numbers.items():
        print(f"check {n} = {v['value']} (limit {v['limit']})",
              file=sys.stderr, flush=True)
