"""s/Mread: the host part of the finalize stage (C++ finalize and BAM
emit, the Python object path for fallbacks; its device wait taken out)
per 10^6 reads."""


def read(run):
    st = run["stages"]
    if "finalize" not in st or not run["reads"]:
        return None
    return (st["finalize"] - st.get("finalize/dsync", 0.0)) / run["reads"] * 1e6
