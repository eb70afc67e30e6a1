"""reads/s: every read aligned and written as BAM in the window, over the
window's whole clock (the time inside the aligner's and the writer's
calls, summed over all its batches)."""


def read(run):
    return run["reads"] / run["window_s"] if run["window_s"] > 0 else None
