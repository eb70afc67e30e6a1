"""Measurement tools of the port, each runnable with ``python -m``:
``genome_scale`` (a whole genome indexed and aligned on the card) and
``thread_tax`` (per-thread CPU seconds around a batch)."""
