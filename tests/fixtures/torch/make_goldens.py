#!/usr/bin/env python3
"""Exhaustive-mode (-i) goldens for the torch port, made by the JAX package.

    JAX_PLATFORMS=cpu python tests/fixtures/torch/make_goldens.py [NAME ...]

The reference binary segfaults on every -i input, so the goldens of -i come
from ``graphaligner_tpu.runtime.aligner.align_reads`` (backend "jax", the
batched exhaustive engine) on the CPU. Each corpus writes
``tests/fixtures/torch/<NAME>/out.gam``. The longsim corpus runs
``BatchAligner.compute_tables`` with ``backend="column"``: the default
wavefront backend does not finish that graph on a CPU in minutes, and
``tests/test_engine.py`` holds the two backends bit-identical.
"""

from __future__ import annotations

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
FIX = os.path.join(ROOT, "tests", "fixtures")

# name -> (graph, reads, compute_tables backend)
CORPORA = {
    "smallexample_i": ("smallexample/sub_test.vg", "smallexample/read.fastq",
                       "wavefront"),
    "sim_i": ("sim/bubbles.vg", "sim/sim.fastq", "wavefront"),
    "longsim_i": ("longsim/graph.vg", "sim/sim.fastq", "column"),
    # a cyclic graph: the JAX engine takes its column backend's fixpoint
    "cyclic_i": ("sim/cyclic.gfa", "torch/cyclic_i/reads.fastq", "column"),
}


def make(name: str, out_gam: str) -> list:
    """Aligns corpus ``name`` in -i mode with the JAX package and writes
    the concatenated GAM to ``out_gam``; returns the alignments."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from graphaligner_tpu.core import engine
    from graphaligner_tpu.core.params import AlignerParams
    from graphaligner_tpu.runtime.aligner import align_reads

    graph, reads, backend = CORPORA[name]
    params = AlignerParams(
        graph_file=os.path.join(FIX, graph),
        fastq_file=os.path.join(FIX, reads),
        alignment_file=out_gam,
        initial_bandwidth=35,
        initial_full_band=True,
    )
    orig = engine.BatchAligner.compute_tables

    def compute_tables(self, sequences, num_slices=None, backend_=None):
        return orig(self, sequences, num_slices, backend=backend)

    engine.BatchAligner.compute_tables = compute_tables
    try:
        with tempfile.TemporaryDirectory() as tmp:
            return align_reads(params, log=lambda *a: None, output_dir=tmp,
                               backend="jax")
    finally:
        engine.BatchAligner.compute_tables = orig


def main(names) -> int:
    import time

    for name in names or sorted(CORPORA):
        out_dir = os.path.join(HERE, name)
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.time()
        alns = make(name, os.path.join(out_dir, "out.gam"))
        print(f"{name}: {len(alns)} alignments in {time.time() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
