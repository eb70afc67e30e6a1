"""Pipeline depth 2 against 1 in one process, on syn45, then chrM.

Depth 2 overlaps the card's kernels with the host stages of the next
chunk; depth 1 runs them in turn.  Both run on one warmed aligner, so
they share its text upload and sticky shapes.  ``--budgets=B1,B2,...``
runs one aligner a problem budget (``PROBLEM_BUDGET``, problems a chunk)
on syn45 as well; the budgets and the depths take turns batch by batch,
their order reversed on every other batch, so that a drift of the host
over the run falls on each setting alike.

Usage (on the card):

    python -m thermite_tpu_torch.tools.depth_ab [n_reads] [trials]
        [--budgets=B1,B2,...]
        (defaults 49152 5, the default budget)

chrM is read from ``data/`` (``tools/workloads.py::CHRM_FASTA``); when
it is absent the tool names the path and exits 2 after syn45's lines.
"""

from __future__ import annotations

import statistics
import sys
from typing import List

from .workloads import (bench_opts, chrm_index, first_chrom, make_reads,
                        syn45_index, timed)


def depth_ab(index, warm: List[bytes], batches: List[List[bytes]],
             device="cuda", budgets=(None,)) -> dict:
    """One ``BatchAligner`` a budget of ``budgets`` (None: the default),
    each warmed with ``warm``; then batch t of ``batches`` at every budget
    and at pipeline depth 2 and 1, both orders reversed on odd t ->
    {budget: {depth: {"median", "lo", "hi", "rates"}}} in reads/s."""
    from ..align.batch import BatchAligner

    aligners = {}
    for b in budgets:
        ba = BatchAligner(index, bench_opts(), device=device)
        if b:
            ba.PROBLEM_BUDGET = b
        ba.align_batch(warm)
        aligners[ba.PROBLEM_BUDGET] = ba
    rates = {b: {2: [], 1: []} for b in aligners}
    for t, batch in enumerate(batches):
        turn = -1 if t % 2 else 1
        for b in list(aligners)[::turn]:
            for depth in (2, 1)[::turn]:
                ba = aligners[b]
                ba.pipeline_depth = depth
                rates[b][depth].append(
                    len(batch) / timed(lambda: ba.align_batch(batch), device))
    return {b: {d: {"median": statistics.median(r), "lo": min(r),
                    "hi": max(r), "rates": r} for d, r in by_depth.items()}
            for b, by_depth in rates.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    n = int(args[0]) if args else 49152
    trials = int(args[1]) if len(args) > 1 else 5
    budgets = (None,)
    for a in argv:
        if a.startswith("--budgets="):
            budgets = tuple(int(b) for b in a.split("=", 1)[1].split(","))
    for label, load in (("syn45", syn45_index), ("chrM", chrm_index)):
        try:
            index = load()
        except FileNotFoundError as e:
            print(f"depth_ab: {e}", file=sys.stderr)
            return 2
        chrom = first_chrom(index)
        res = depth_ab(index, make_reads(chrom, n, seed=5),
                       [make_reads(chrom, n, seed=30 + t) for t in range(trials)],
                       budgets=budgets if label == "syn45" else (None,))
        for budget, by_depth in res.items():
            for depth, r in by_depth.items():
                print(f"{label} budget={budget} depth={depth}: median "
                      f"{r['median']:.0f} reads/s [{r['lo']:.0f}, "
                      f"{r['hi']:.0f}] " + " ".join(f"{x:.0f}" for x in r["rates"]),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
