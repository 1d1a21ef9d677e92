"""The yardstick: the work the algorithm needs for a window's reads, and
the card's peak rates that bound how fast it could be done.

The work is counted from what the reads need, the same whatever kernel
does it: K1's from the band cells of the reads (``cells_processed``, the
reference's cellsProcessed), K2's from the backtrace steps of their
traces. Each unit's operations and bytes are fixed here, from the scalar
algorithm, and never from a kernel's source, so that a redesigned kernel
does not move its own yardstick.

- A word step (K1): one graph position of a 64-row slice, as the
  reference's bit-parallel slice (GraphAligner.h getNextSlice /
  calculateNode) advances it: the Myers advance of a 64-bit column,
  Xv = Eq | Mv, Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq, Ph = Mh-shifted
  Mv | ~(Xh | Pv), Mh = Pv & Xh, Pv' = Mh | ~(Xv | Ph), Mv' = Ph & Xv,
  with the horizontal carry in and out and the column's end score: 17
  operations on 64-bit words, 34 in 32-bit lanes (the 64-bit add as 3).
  Its bytes: the column it leaves for the backtrace, Pv and Mv (8 bytes
  each) and the end score (4 bytes), written once. The merges at node
  starts depend on the band and are not counted, so the bound is a floor.
  ``cells_processed`` counts cells (a graph position times a read row),
  64 a word step.
- A backtrace step (K2): one move of the scalar backtrace
  (``core/backtrace.py::pick_backtrace_predecessor`` inside a node): four
  cell values (here, horizontal, diagonal, up) each rebuilt from its
  column's end score and the popcounts of its masked Pv and Mv (8
  operations in 32-bit lanes), and up to three compares and selects (8):
  40 operations. Its bytes: the column it moves to, 20 bytes read once,
  and its move, at most a byte, written.
"""

from __future__ import annotations

import subprocess

CELLS_PER_WORD = 64
K1_OPS_PER_WORD = 34
K1_BYTES_PER_WORD = 20
K2_OPS_PER_STEP = 40
K2_BYTES_PER_STEP = 21

# NVIDIA's data sheet for the H100 SXM: HBM3 at 3.35 TB/s, at the card's
# full power limit of 700 W (results carry the card's own limit beside them)
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


def int32_rate(device_index: int = 0) -> float:
    """int32 operations a second the card can issue: SMs x 64 INT32 lanes x
    the maximum SM clock nvidia-smi reports."""
    import torch

    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", f"--id={device_index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def power_limit_w(device_index: int = 0) -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def bound_s(ops: float, nbytes: float, rate: float) -> float:
    """The least time the card could take: the larger of operations over
    the int32 rate and bytes over the memory rate."""
    return max(ops / rate, nbytes / HBM_BYTES_PER_S)


def k1_bound_s(cells: int, rate: float) -> float:
    words = cells / CELLS_PER_WORD
    return bound_s(words * K1_OPS_PER_WORD, words * K1_BYTES_PER_WORD, rate)


def k2_bound_s(steps: int, rate: float) -> float:
    return bound_s(steps * K2_OPS_PER_STEP, steps * K2_BYTES_PER_STEP, rate)
