"""cProfile of the batch pipeline's host side.

Builds the chrM index (or syn45 with ``PP_SYN=1``), warms the aligner
with one batch of the full size (the text upload, the first launches,
the sticky shapes), then profiles ``align_batch`` (and, with
``PP_EMIT=1``, ``align_batch_emit`` to BAM) over N reads and prints the
top host functions by the sort key.  The card's work overlaps the host
stages, so what shows here is the host budget that sets the pace.
cProfile adds cost to every Python call and none to native code, so the
shares lean towards Python; reads/s is printed beside each profile.

Usage (on the card):

    [PP_SYN=1] [PP_EMIT=1] python -m thermite_tpu_torch.tools.profile_pipeline [n_reads] [sort]
        (defaults 49152 tottime)
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import sys
from typing import List

from .workloads import bench_opts, chrm_index, first_chrom, make_reads, syn45_index, timed


def top_functions(prof: cProfile.Profile, sort: str, top: int) -> List[dict]:
    """The first ``top`` functions of the profile by ``sort``."""
    st = pstats.Stats(prof).sort_stats(sort)
    rows = []
    for func in st.fcn_list[:top]:
        cc, nc, tt, ct, _ = st.stats[func]
        rows.append({"function": pstats.func_std_string(func), "ncalls": nc,
                     "tottime": tt, "cumtime": ct})
    return rows


def _profiled(run, device, sort, top):
    prof = cProfile.Profile()
    prof.enable()
    try:
        seconds = timed(run, device)
    finally:
        prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats(sort).print_stats(top)
    return seconds, top_functions(prof, sort, top), text.getvalue()


def profile_pipeline(index, reads, warm, device="cuda", emit: bool = False,
                     sort: str = "tottime", top: int = 35,
                     emit_top: int = 25) -> dict:
    """Warm a ``BatchAligner(index, bench_opts(), device=device)`` with
    ``warm``, then profile ``align_batch(reads)`` (and with ``emit``,
    ``align_batch_emit`` to BAM, after an emit warm-up of 4096 reads)
    -> {"warmup_s", "align_batch": part[, "align_batch_emit": part]}; a
    part holds reads_s, seconds, the stage report, the ``top`` rows by
    ``sort`` and the printed profile."""
    from ..align.batch import BatchAligner

    ba = BatchAligner(index, bench_opts(), device=device)
    out = {"warmup_s": timed(lambda: ba.align_batch(warm), device)}
    ba.stats.reset()
    seconds, rows, text = _profiled(lambda: ba.align_batch(reads), device,
                                    sort, top)
    out["align_batch"] = {"reads_s": len(reads) / seconds, "seconds": seconds,
                          "report": ba.stats.report(), "top": rows,
                          "profile": text}
    if emit:
        recs = [(b"r%d" % i, r, b"I" * len(r)) for i, r in enumerate(reads)]
        ba.align_batch_emit(recs[:4096], True)
        ba.stats.reset()
        raw = []
        seconds, rows, text = _profiled(
            lambda: raw.append(ba.align_batch_emit(recs, True)), device, sort,
            emit_top)
        if len(raw[0]) <= len(recs) * 50:
            raise RuntimeError(f"{len(raw[0])} BAM bytes for {len(recs)} reads")
        out["align_batch_emit"] = {
            "reads_s": len(recs) / seconds, "seconds": seconds,
            "report": ba.stats.report(), "top": rows, "profile": text}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 49152
    sort = argv[1] if len(argv) > 1 else "tottime"
    if os.environ.get("PP_SYN", "0") == "1":
        index = syn45_index()
    else:
        try:
            index = chrm_index()
        except FileNotFoundError as e:
            print(f"profile_pipeline: {e}; PP_SYN=1 profiles syn45",
                  file=sys.stderr)
            return 2
    chrom = first_chrom(index)
    # warm at the full batch size: sticky shapes follow the largest batch
    res = profile_pipeline(index, make_reads(chrom, n, seed=7),
                           make_reads(chrom, n, seed=8),
                           emit=os.environ.get("PP_EMIT", "0") == "1",
                           sort=sort)
    print(f"warmup {res['warmup_s']:.1f} s", file=sys.stderr)
    for name in ("align_batch", "align_batch_emit"):
        if name in res:
            part = res[name]
            print(f"{name}: {part['reads_s']:.1f} reads/s "
                  f"({part['seconds']:.2f} s)")
            print(part["report"], file=sys.stderr)
            print(part["profile"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
