"""Host seeding microbenchmark: ``thermite_smems``, the chunk build's
seed phase, over synthetic reads against an artifact-loaded index (the
posting-array reads that dominate chromosome-scale chunk builds).  It
runs on the host alone: no device is touched.

Usage:

    python -m thermite_tpu_torch.tools.seed_bench [artifact] [n_reads] [passes]
        (defaults: the cached syn45 index, built when absent; 50000; 3)
"""

from __future__ import annotations

import os
import sys
import time

from .workloads import OUT_DIR, first_chrom, make_reads, syn45_index


def seed_bench(index, reads, passes: int = 3) -> dict:
    """The index's C++ seeder over ``reads``, ``passes`` times ->
    {"seeder_init_s", "passes": [(us/read, reads/s)], "mems_per_read"}."""
    from ..seed.native import make_seeder

    t0 = time.perf_counter()
    seeder = make_seeder(index.seq_arr, 20,
                         table=getattr(index, "seed_table", None),
                         stride_known=getattr(index, "seed_stride", None))
    init_s = time.perf_counter() - t0
    n = len(reads)
    total, out = 0, []
    for _ in range(passes):
        t0 = time.perf_counter()
        for r in reads:
            total += len(seeder.all_smems(r))
        dt = time.perf_counter() - t0
        out.append((dt / n * 1e6, n / dt))
    return {"seeder_init_s": init_s, "passes": out,
            "mems_per_read": total / n / passes}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    art = argv[0] if argv else os.path.join(OUT_DIR, "bench_syn45.npz")
    n = int(argv[1]) if len(argv) > 1 else 50_000
    passes = int(argv[2]) if len(argv) > 2 else 3
    t0 = time.time()
    if argv:
        from ..index.build import Index

        index = Index.load(art)
    else:
        index = syn45_index()
    print(f"index loaded in {time.time() - t0:.1f} s", file=sys.stderr)
    res = seed_bench(index, make_reads(first_chrom(index), n, seed=42), passes)
    print(f"seeder init in {res['seeder_init_s']:.1f} s", file=sys.stderr)
    for p, (us, rps) in enumerate(res["passes"]):
        print(f"pass {p}: {us:.2f} us/read ({rps:.0f} reads/s)")
    print(f"mems/read {res['mems_per_read']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
