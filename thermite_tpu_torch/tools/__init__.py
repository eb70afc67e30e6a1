"""Measurement tools of the port, each runnable with ``python -m``:
``genome_scale`` (a whole genome indexed and aligned on the card),
``thread_tax`` (per-thread CPU seconds around a batch), ``fuzz_parity``
(mutated reads against the oracle), ``profile_pipeline`` (cProfile of the
host side), ``build_split`` (seeding against the whole chunk build),
``seed_bench`` and ``table_bench`` (seeding and seed-table build),
``depth_ab`` (pipeline depth 2 against 1), ``golden_diff`` (metrics
tables within a tolerance) and ``make_reads`` (a FASTQ of bench reads).
``workloads`` holds the data builders they share."""
