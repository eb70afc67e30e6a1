"""s/Mread: the program's span ``dispatch`` (``BatchAligner._dispatch_forward``:
the device meta narrowed, rows sorted by ylen, padded and packed, the stream
kernel's launch and the start of its headers' copy) per 10^6 reads."""


def read(run):
    s = run["stages"].get("dispatch")
    return None if s is None or not run["reads"] else s / run["reads"] * 1e6
