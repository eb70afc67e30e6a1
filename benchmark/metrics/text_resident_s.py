"""s: set-up's resident text (``BatchAligner._ref_text``): the nibble pack
on the host, when the artifact does not carry it, and the upload to the
card (the program's ``text pack`` and ``text upload`` stages)."""


def read(run):
    sp = run["setup_spans"]
    parts = [sp[k] for k in ("text pack", "text upload") if k in sp]
    return sum(parts) if parts else None
