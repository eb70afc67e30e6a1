"""s: from the start of the benchmark's process (before torch is
imported) through the card probe, the index, the aligner, the resident
text and one warm-up batch of the cell's traffic.  What a checkout's
first run builds once (the genome's FASTA and GTF, the artifact) is
timed apart, as ``cache_build_s`` in the result line, and left out."""


def read(run):
    return run["setup_s"]
