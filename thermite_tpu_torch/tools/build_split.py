"""The host build stage split: seeding (``thermite_smems``) against the
whole C++ chunk build (seeding, windows, tasks, problems and transcript
candidates).

Usage:

    python -m thermite_tpu_torch.tools.build_split [n_reads] [artifact.npz]
        (defaults 8192 and the cached syn45 index, built when absent;
        data/out/genome_scale/wg_index.npz measures against the
        whole-genome packed table, with truth reads drawn from its text)

Only host stages run: no kernel is launched.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .workloads import bench_opts, first_chrom, make_reads, syn45_index


def build_split(index, reads, device="cuda", trials: int = 3) -> dict:
    """Seeding of every read by the aligner's seeder, then the C++ chunk
    build of the whole batch (best of ``trials``), on a
    ``BatchAligner(index, bench_opts(), device=device)`` -> dict of
    microseconds and reads/s of each, SMEMs and problems."""
    from ..align.batch import BatchAligner

    ba = BatchAligner(index, bench_opts(), device=device)
    if ba.native is None:
        raise RuntimeError("the chunk build needs the C++ engine")
    n = len(reads)
    seeder = ba.seeder
    for r in reads[:256]:
        seeder.all_smems(r)  # warm
    t0 = time.perf_counter()
    mems = sum(len(seeder.all_smems(r)) for r in reads)
    seed_s = time.perf_counter() - t0

    rpad = max(96, -(-max(map(len, reads)) // 32) * 32)
    reads_pad = np.zeros((n, rpad), np.uint8)
    lens = np.zeros(n, np.int64)
    for i, r in enumerate(reads):
        reads_pad[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        pos = problems = 0
        while pos < n:
            ch, consumed, meta, _ = ba.native.build_chunk(
                reads_pad[pos:], lens[pos:], n - pos, ba.PROBLEM_BUDGET)
            problems += len(meta)
            ba.native.free_chunk(ch)
            pos += consumed
        best = min(best, time.perf_counter() - t0)
    return {"reads": n, "seed_us_per_read": 1e6 * seed_s / n,
            "seed_reads_s": n / seed_s, "mems": mems,
            "build_us_per_read": 1e6 * best / n, "build_reads_s": n / best,
            "problems": problems}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8192
    t0 = time.time()
    if len(argv) > 1:
        from ..index.build import Index
        from ..testing.synth import make_truth_reads

        index = Index.load(argv[1])
        reads = [r[1] for r in make_truth_reads(index, n, seed=77)]
    else:
        index = syn45_index()
        reads = make_reads(first_chrom(index), n, seed=77)
    print(f"index loaded {time.time() - t0:.1f} s", file=sys.stderr)
    res = build_split(index, reads)
    print(f"seed-only: {res['seed_us_per_read']:.1f} us/read "
          f"({res['seed_reads_s']:.0f}/s, {res['mems']} mems)\n"
          f"full build: {res['build_us_per_read']:.1f} us/read "
          f"({res['build_reads_s']:.0f}/s, {res['problems']} problems)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
