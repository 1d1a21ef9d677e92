"""Read bases of every read in the window's completed calls over the
window's seconds (host clock)."""


def read(run):
    return run.bases / run.window_s if run.window_s > 0 else None
