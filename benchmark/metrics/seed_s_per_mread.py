"""s/Mread: the program's span ``build/seed`` (``native.build_chunk``: the C++
seeding and task build over the build pool) per 10^6 reads."""


def read(run):
    s = run["stages"].get("build/seed")
    return None if s is None or not run["reads"] else s / run["reads"] * 1e6
