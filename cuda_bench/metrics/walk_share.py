"""Host-clock seconds in the walk (BandedBatchAligner._walk: consolidation, K2, decode)
over the traced call's wall."""


def read(run):
    rec = run.record
    if rec is None or rec.window_s <= 0:
        return None
    return rec.spans.seconds("walk") / rec.window_s
