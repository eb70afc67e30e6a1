"""Seed-table build microbenchmark (host only, no device).

Times ``thermite_seed_index_new_stride`` on a random ACGT text of a
chosen size, on the packed-u64 path (default) or the (key, pos) pair
path (``--pair``, through ``THERMITE_TABLE_PAIR=1``), in ns a position,
with the projection to a whole genome's 1.6G positions.  Locality costs
show only past about 100 Mbp.

Usage:

    python -m thermite_tpu_torch.tools.table_bench [Mbp] [stride] [k] [--pair]
        (defaults 800 4 20)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def random_text(n: int, seed: int = 99) -> np.ndarray:
    """``n`` random ACGT bytes (integers + take: rng.choice draws int64
    indices, 8n bytes of temporaries)."""
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n, dtype=np.uint8)]


def build_table(arr: np.ndarray, k: int, stride: int, pair: bool = False):
    """-> (the C++ seed engine of ``arr``, build seconds); ``pair``
    forces the pair path for this build only."""
    from ..seed.native import NativeSmemEngine

    old = os.environ.get("THERMITE_TABLE_PAIR")
    if pair:
        os.environ["THERMITE_TABLE_PAIR"] = "1"
    try:
        t0 = time.perf_counter()
        eng = NativeSmemEngine(arr, k, stride=stride)
        return eng, time.perf_counter() - t0
    finally:
        if pair:
            if old is None:
                del os.environ["THERMITE_TABLE_PAIR"]
            else:
                os.environ["THERMITE_TABLE_PAIR"] = old


def table_bench(mbp: float, stride: int = 4, k: int = 20,
                pair: bool = False) -> dict:
    n = int(mbp * 1e6)
    t0 = time.perf_counter()
    arr = random_text(n)
    synth_s = time.perf_counter() - t0
    eng, dt = build_table(arr, k, stride, pair)
    del eng
    npos = (n - k + stride) // stride
    return {"path": "pair" if pair else "packed", "bp": n, "synth_s": synth_s,
            "build_s": dt, "positions": npos, "ns_per_pos": dt * 1e9 / npos,
            "genome_min": dt * 1.6e9 / npos / 60}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    res = table_bench(float(args[0]) if args else 800,
                      int(args[1]) if len(args) > 1 else 4,
                      int(args[2]) if len(args) > 2 else 20,
                      "--pair" in argv)
    print(f"synth {res['bp'] / 1e6:.0f} Mbp in {res['synth_s']:.1f}s")
    print(f"{res['path']}: {res['build_s']:.1f}s for "
          f"{res['positions'] / 1e6:.0f}M positions = {res['ns_per_pos']:.0f} "
          f"ns/pos (genome 1.6G-pos projection: {res['genome_min']:.1f} min)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
