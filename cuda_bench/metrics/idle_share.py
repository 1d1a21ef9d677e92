"""1 - the seconds in which an operation (kernel, copy, memset) ran on the
card, from torch.profiler, over the traced call's wall."""


def read(run):
    rec = run.record
    if rec is None or not rec.events or rec.window_s <= 0:
        return None
    return 1.0 - rec.busy_s / rec.window_s
