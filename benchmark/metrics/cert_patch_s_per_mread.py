"""s/Mread: the program's span ``arbitrate/patch`` (``native.patch_rows``: the
C++ scalar recompute of the narrow band's certificate failures, opened only
when a chunk has some) per 10^6 reads; 0 where ``arbitrate`` ran without a
patch.  None for a program that records no spans inside ``arbitrate`` (no
``arbitrate/cpu``)."""


def read(run):
    st = run["stages"]
    if "arbitrate/cpu" not in st or not run["reads"]:
        return None
    return st.get("arbitrate/patch", 0.0) / run["reads"] * 1e6
