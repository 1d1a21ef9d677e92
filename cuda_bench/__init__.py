"""The benchmark of graphaligner_tpu_torch, the PyTorch and CUDA port.

``python3 cuda_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout runs one cell of
``BENCHMARK.json`` on the card and prints its result as the last line of
standard output. Everything the harness needs is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``, the graph
generator ``gen/<generator>.py`` a configuration names, and one reader
``metrics/<metric>.py`` a per-layer metric. ``yardstick.py`` holds the
work constants and the card's peak rates; ``reference/`` is the plain
aligner the answers are held against.
"""
