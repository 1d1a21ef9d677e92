"""Host-clock seconds in the scan rounds and their control replay (BandedBatchAligner._run)
over the traced call's wall."""


def read(run):
    rec = run.record
    if rec is None or rec.window_s <= 0:
        return None
    return rec.spans.seconds("scan") / rec.window_s
