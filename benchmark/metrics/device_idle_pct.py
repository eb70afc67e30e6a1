"""%: the share of the traced sub-window (a few steady batches after the
window) in which no kernel or copy ran on the card, from the
``torch.profiler`` trace: 100 - 100 * (union of device intervals) / wall."""


def read(run):
    t = run.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
