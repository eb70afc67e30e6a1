"""s/Mread: the process's CPU seconds (every thread's) inside the program's
span ``build`` (``build/cpu``) per 10^6 reads; against
``build_s_per_mread``, how many cores the build keeps busy."""


def read(run):
    s = run["stages"].get("build/cpu")
    return None if s is None or not run["reads"] else s / run["reads"] * 1e6
