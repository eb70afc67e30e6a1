"""Tolerance-banded golden comparison for metrics tables.

A plain ``diff`` against a golden table breaks on a single boundary read
(at 3000 reads one read is 0.03%).  This checker compares the markdown
tables row by row and fails only when a numeric field drifts more than
``--tol`` (default 0.005, half a percentage point), or when a row is
missing, unexpected or differs as text.

Usage:

    python -m thermite_tpu_torch.tools.golden_diff GOLDEN [--tol T] < actual_table

Exits 1, printing the offending rows to stderr, on a mismatch.
"""

from __future__ import annotations

import argparse
import sys


def parse_table(lines):
    """``|name|value|`` rows -> {name: float, or the text when not a
    number}; the header and separator rows are skipped."""
    rows = {}
    for ln in lines:
        ln = ln.strip()
        if not ln.startswith("|") or ln.startswith("|-") or ln.startswith("|metric"):
            continue
        parts = [p.strip() for p in ln.strip("|").split("|")]
        if len(parts) < 2:
            continue
        try:
            rows[parts[0]] = float(parts[1])
        except ValueError:
            rows[parts[0]] = parts[1]
    return rows


def compare(want: dict, got: dict, tol: float) -> list:
    """The offending rows of ``got`` against ``want``, as lines."""
    bad = []
    for key, w in want.items():
        if key not in got:
            bad.append(f"missing row: {key!r}")
            continue
        g = got[key]
        if isinstance(w, float) and isinstance(g, float):
            if abs(g - w) > tol:
                bad.append(f"{key!r}: {g} vs golden {w} (tol {tol})")
        elif g != w:
            bad.append(f"{key!r}: {g!r} vs golden {w!r}")
    for key in got:
        if key not in want:
            bad.append(f"unexpected row: {key!r}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("golden")
    ap.add_argument("--tol", type=float, default=0.005)
    args = ap.parse_args(argv)

    with open(args.golden) as f:
        want = parse_table(f)
    bad = compare(want, parse_table(sys.stdin), args.tol)
    if bad:
        print("golden mismatch:\n  " + "\n  ".join(bad), file=sys.stderr)
        return 1
    print(f"golden ok ({len(want)} rows within tol {args.tol})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
