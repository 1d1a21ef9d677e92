"""Host-clock seconds in the finalize (native.TracePieceCtx.piece, the CLI's per-read finalize and GAM encode)
over the traced call's wall."""


def read(run):
    rec = run.record
    if rec is None or rec.window_s <= 0:
        return None
    return rec.spans.seconds("finalize") / rec.window_s
