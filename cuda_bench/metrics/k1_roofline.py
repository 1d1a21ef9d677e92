"""K1's share of its roofline: the least time the card could take for the
traced call's band cells (yardstick.k1_bound_s of the reads'
cells_processed) over the summed device time of the slice_cells kernels,
both routes, in %."""

from ..yardstick import k1_bound_s


def read(run):
    rec = run.record
    if rec is None or rec.cells <= 0:
        return None
    n, seconds = rec.device_seconds(("slice_cells",))
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * k1_bound_s(rec.cells, rec.int32_rate) / seconds
