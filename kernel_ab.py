#!/usr/bin/env python3
"""Time the CUDA kernels of two checkouts in turns on one card.

    python3 kernel_ab.py --parent DIR [--json OUT]

``DIR`` holds another checkout of the repository (for example
``git archive <commit> | tar -x -C data/out/parent``).  Two versions are
only comparable on one card within one call, so the script runs
``chip_smoke.py --time-kernels`` of each checkout, one process a turn, in
the order parent, change, change, parent: each checkout builds and times
its own kernels on the same seeded inputs (see ``time_kernels`` in
``chip_smoke.py``).  It prints the card's name and power limit, every
measurement with each turn's time, and the instruction mix of each
checkout's stream-kernel column loops; ``--json`` writes them to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the other checkout's directory")
    ap.add_argument("--json", help="write the measurements to this file")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    parent = os.path.abspath(args.parent)
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, (who, root) in enumerate((("parent", parent), ("change", ROOT),
                                         ("change", ROOT), ("parent", parent))):
            out = os.path.join(tmp, f"turn{k}.json")
            r = subprocess.run(
                [sys.executable, os.path.join(root, "chip_smoke.py"),
                 "--time-kernels", out],
                cwd=root, capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"the {who} turn failed")
            with open(out) as f:
                turns.append({"checkout": who, **json.load(f)})
    print("ms per launch, turns: " + ", ".join(t["checkout"] for t in turns))
    for name in dict.fromkeys(n for t in turns for n in t["ms"]):
        print(f"  {name}: " + ", ".join(
            f"{t['ms'][name]:.4f}" if name in t["ms"] else "-" for t in turns))
    print("instructions of each stream kernel's column loop (cuobjdump -sass):")
    for t in turns[:2]:
        for entry, counts in t["sass"].items():
            print(f"  {t['checkout']} {entry}: {counts}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
