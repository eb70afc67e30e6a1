"""s/Mread: the program's span ``finalize/emit`` (``native.emit_chunk``: the
C++ BAM records, with the three record lists it is handed) per 10^6
reads."""


def read(run):
    s = run["stages"].get("finalize/emit")
    return None if s is None or not run["reads"] else s / run["reads"] * 1e6
