"""The benchmark's plain reference: the scalar seeded banded aligner.

Plain Python and NumPy, with the per-slice DP in a small C++ routine
(``slice.cpp``) built into ``cuda_bench/.build/``. It imports nothing of
the program and takes nothing the program made: it builds its own graph
from the generator's arrays or the GFA text the benchmark hands to both
sides, and aligns each read alone (``seeded.align``).
"""
