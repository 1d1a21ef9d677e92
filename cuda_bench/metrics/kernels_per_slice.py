"""Device operations the profiler saw in the traced call over its fused
K1 launches (one a slice; ops.banded_cell's LAUNCHES counters)."""


def read(run):
    rec = run.record
    if rec is None or not rec.events or rec.launches <= 0:
        return None
    return len(rec.events) / rec.launches
