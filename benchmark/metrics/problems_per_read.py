"""problems/read: extension problems the host build made per read, an
exact count (``stats.problems / stats.reads``)."""


def read(run):
    c = run["counters"]
    return c["problems"] / c["reads"] if c["reads"] else None
