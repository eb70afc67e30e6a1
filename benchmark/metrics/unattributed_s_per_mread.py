"""s/Mread: the window's time that no span covers, per 10^6 reads: the
window less the BAM writer and less every top-level span of the program
(a stage key without ``/``; the set-up's ``text`` spans are not in the
window).  None for a program without the span ``dispatch``, whose launch
this would count."""


def read(run):
    st = run["stages"]
    if "dispatch" not in st or not run["reads"]:
        return None
    spans = sum(v for k, v in st.items()
                if "/" not in k and not k.startswith("text "))
    return (run["window_s"] - run["bam_write_s"] - spans) / run["reads"] * 1e6
