"""s/Mread: the program's spans ``arbitrate/lift`` (the C++ arbitration's
transcript winners: ``lift_tx_span`` and its bookkeeping) and
``finalize/lift`` (the C++ finalize's exonic branch: ``lift_runs``,
``chr_runs`` and the transcript payload), summed, per 10^6 reads; each is
recorded where a chunk had exonic alignments.  None for a program that
records neither."""


def read(run):
    st = run["stages"]
    keys = [k for k in ("arbitrate/lift", "finalize/lift") if k in st]
    if not keys or not run["reads"]:
        return None
    return sum(st[k] for k in keys) / run["reads"] * 1e6
