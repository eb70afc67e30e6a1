"""s/Mread: the host's waits for the card and the copies back (the
arbitrate and finalize ``dsync`` stages) per 10^6 reads."""


def read(run):
    st = run["stages"]
    waits = [v for k, v in st.items() if k.endswith("/dsync")]
    return sum(waits) / run["reads"] * 1e6 if waits and run["reads"] else None
