"""%: narrow-band certificate failures recomputed on the host, per 100
extension problems (``100 * stats.cert_patches / stats.problems``):
device work done twice."""


def read(run):
    c = run["counters"]
    return 100.0 * c["cert_patches"] / c["problems"] if c["problems"] else None
