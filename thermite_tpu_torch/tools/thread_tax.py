"""Per-thread CPU accounting for the batch pipeline.

The pipeline's stage timers attribute wall time to stages; they cannot
say which threads burned the CPU inside them (the host build, the C++
engine's worker threads, the CUDA runtime, the pinned-copy threads).
This tool snapshots ``/proc/self/task/*/stat`` utime+stime around a
warmed ``align_batch_emit`` and reports each thread's CPU seconds.

Usage (on the card):

    python -m thermite_tpu_torch.tools.thread_tax [n_reads]

runs syn45 (the 45 Mbp synthetic chromosome ``chip_smoke.py`` builds,
seed 1234), 49152 truth reads by default, three trials after a warm-up
batch of the same size.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Tuple

SYN_BP = 45_000_000


def thread_cpu() -> Dict[int, Tuple[str, float]]:
    """tid -> (comm, cpu_seconds) from /proc/self/task/*/stat."""
    hz = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                raw = f.read()
        except OSError:
            continue  # the thread ended between listdir and open
        # comm may contain spaces; it is parenthesized
        lp, rp = raw.index("("), raw.rindex(")")
        fields = raw[rp + 2 :].split()
        utime, stime = int(fields[11]), int(fields[12])
        out[int(tid)] = (raw[lp + 1 : rp], (utime + stime) / hz)
    return out


def thread_tax(run: Callable[[], object], min_s: float = 0.005):
    """Call ``run()`` -> (its result, wall seconds, rows): one row
    ``(cpu_seconds, tid, comm)`` for every thread that used more than
    ``min_s`` CPU seconds during the call (threads born inside it
    count from zero), most first."""
    before = thread_cpu()
    t0 = time.perf_counter()
    result = run()
    wall = time.perf_counter() - t0
    rows = []
    for tid, (comm, cpu) in thread_cpu().items():
        d = cpu - before.get(tid, (comm, 0.0))[1]
        if d >= min_s:
            rows.append((d, tid, comm))
    rows.sort(reverse=True)
    return result, wall, rows


def format_rows(rows: List[tuple], wall: float, top: int = 0) -> List[str]:
    """Report lines: the total, then each thread (the first ``top``
    when ``top`` > 0) with its share of the wall."""
    total = sum(r[0] for r in rows)
    lines = [f"total thread CPU {total:.3f} s ({100 * total / wall:.0f}% of "
             f"wall {wall:.3f} s; the rest is blocked waits)"]
    for d, tid, comm in rows[:top] if top else rows:
        tag = " [main]" if tid == os.getpid() else ""
        lines.append(f"  {d:7.3f} s  {100 * d / wall:5.1f}%  tid {tid:<8d} "
                     f"{comm}{tag}")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_reads = int(argv[0]) if argv else 49152

    import torch

    from ..align.batch import BatchAligner
    from ..align.driver import AlignOpts
    from ..index.build import Index
    from ..testing.synth import make_truth_reads, write_synth_genome

    out = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data", "out")
    os.makedirs(out, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        fasta, gtf = write_synth_genome(tmp, SYN_BP, seed=1234,
                                        basename="syn45")
        index = Index.create_from_files(fasta, gtf)
    opts = AlignOpts(min_seed_len=20, min_aln_score_percent=0.0,
                     min_aln_score=30, intron_mode=True)
    ba = BatchAligner(index, opts, device="cuda")
    recs = [(n.encode(), s, b"I" * len(s))
            for n, s in make_truth_reads(index, n_reads, seed=23)]
    # warm at full size: first launches, shape buckets, the text upload
    ba.align_batch_emit(recs, True)
    for trial in range(3):
        ba.stats.reset()
        _, wall, rows = thread_tax(
            lambda: (ba.align_batch_emit(recs, True), torch.cuda.synchronize()))
        print(f"trial {trial}: wall {wall:.3f} s   reads {n_reads}   "
              f"{n_reads / wall:.0f} reads/s   depth {ba.pipeline_depth}")
        print("\n".join("  " + ln for ln in format_rows(rows, wall)))
    print(ba.stats.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
