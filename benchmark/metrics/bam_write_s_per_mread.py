"""s/Mread: the benchmark's own span around ``BamWriter.write_raw`` (BGZF
blocks compressed with zlib in Python) per 10^6 reads."""


def read(run):
    return run["bam_write_s"] / run["reads"] * 1e6 if run["reads"] else None
