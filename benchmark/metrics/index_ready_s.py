"""s: the benchmark's span in set-up around the index: the artifact's
memory-mapped load and page warm-up, or the in-memory build from the
FASTA and GTF with the seed table.  A checkout's first run builds the
artifact before set-up starts (``cache_build_s``), so the span never
holds that build."""


def read(run):
    return run["setup_spans"].get("index_ready")
