"""s/Mread: the host part of the arbitrate stage (C++ arbitration and the
certificate patches; its device wait taken out) per 10^6 reads."""


def read(run):
    st = run["stages"]
    if "arbitrate" not in st or not run["reads"]:
        return None
    return (st["arbitrate"] - st.get("arbitrate/dsync", 0.0)) / run["reads"] * 1e6
