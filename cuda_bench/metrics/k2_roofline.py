"""K2's share of its roofline: the least time the card could take for the
backtrace steps of the traced call's traces (yardstick.k2_bound_s) over
the summed device time of the walk_moves kernels, both routes, in %."""

from ..yardstick import k2_bound_s


def read(run):
    rec = run.record
    if rec is None or rec.steps <= 0:
        return None
    n, seconds = rec.device_seconds(("walk_moves",))
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * k2_bound_s(rec.steps, rec.int32_rate) / seconds
