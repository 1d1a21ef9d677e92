"""Seconds from the process's start (the first line of run.py) to the
first timed call: CUDA init, the extensions, the graph, its tables, the
reach table, the device tables, the read pool and the warm-up call."""


def read(run):
    return run.setup_s
