"""Device time of the band projection's kernels (ops/project_band.py) in
the traced call over its fused K1 launches, in us a slice."""


def read(run):
    rec = run.record
    if rec is None or rec.launches <= 0:
        return None
    n, seconds = rec.device_seconds(("project_band",))
    if n == 0:
        return None
    return seconds / rec.launches * 1e6
