"""GiB: the process's peak resident memory (``ru_maxrss``) read when the
window ends, before the check builds its reference."""


def read(run):
    return run["host_peak_bytes"] / 2**30
