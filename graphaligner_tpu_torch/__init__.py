"""graphaligner_tpu_torch — the aligner on PyTorch and CUDA (NVIDIA Hopper).

A port of ``graphaligner_tpu`` that keeps its layout, so each module's
counterpart is easy to find:

  ops/      torch twins of the word ops, and the hand-written CUDA
            kernels with their plain versions: banded_cell.slice_cells (K1,
            a banded slice's metadata pass fused with its cell passes),
            walk_moves (K2, the backtrace walk) and exhaustive (K3, the -i
            column DP: a slice wavefront, and a serial kernel for cyclic
            graphs); ops/_build.py compiles csrc/*.cu with nvcc
  csrc/     the CUDA C++ sources (sm_90a)
  core/     the banded slice scan (engine_banded), the batched seeded
            orchestration (batch_align) and the exhaustive-mode engine
            (engine) on torch tensors, plus the host modules (params,
            result, hmm, oracle, band, backtrace, align, reach, trace_ops)
  graph/    graph loading and the runtime graph index
  io/       reads, vg messages, GAM streams, and the native host library
            (native/ga_native.cpp, built by io/native.py)
  runtime/  align_reads and the CLI (seeded banded mode and -i on a
            device, and the per-read host path, --backend oracle)
  parallel/ the device mesh and multi-process runs
  tools/    the ecosystem tools (python -m graphaligner_tpu_torch.tools.X)
  utils/    line-atomic logging and the tracer (spans and counters)

The port is self-contained: it imports neither jax nor
``graphaligner_tpu``. The jax-free host modules are copies of the JAX
package's, each naming its source in its first line. Every entry point
takes an explicit device: ``cuda`` runs the kernels, ``cpu`` runs their
plain versions, and the CLI's ``oracle`` aligns on the host alone.
"""

__version__ = "0.1.0"
