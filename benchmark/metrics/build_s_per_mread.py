"""s/Mread: the host build stage (C++ seeding and task build, read
upload) over the window, per 10^6 reads (``stats.stage_s["build"]``)."""


def read(run):
    s = run["stages"].get("build")
    return None if s is None or not run["reads"] else s / run["reads"] * 1e6
