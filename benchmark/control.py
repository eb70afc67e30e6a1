"""The control of the check: the reference without the genome-versus-
transcriptome arbitration, put in the program's place and judged as a
run's records are.

    python3 benchmark/control.py --workload <name> --batches <n> --seeds <s> ...

For each seed it takes the reads that a run of ``n`` batches would check
(the same kept batches and the same sample), aligns them with the
reference and with the control, and prints the control's
``mismatched_reads`` beside the limit: the control has to fail it.  It
needs no card (the program does not run); on the chip's machine it runs
at the cell's own size.  The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_readings(root: str, workload: str, batches: int, seeds):
    """-> [{seed, checked_reads, mismatched_reads (the control's)}] for
    each seed."""
    from benchmark import check
    from benchmark.harness import cache_dir, find_cell, generator
    from benchmark.reference import Reference
    from benchmark.reference.genome import Genome

    _, _, cfg, traffic = find_cell(root, workload)
    gen = generator(root, traffic["generator"])
    genome = generator(root, "synth_genome").ensure(cache_dir(root), cfg)
    samples = []
    for seed in seeds:
        kept = [(b, gen.make_batch(genome, traffic, seed, 0, b))
                for b in range(batches) if check.retained(seed, b)]
        picks = check.sample(seed, kept, check.CHECK_READS)
        samples.append({(kept[s][0], i): kept[s][1][i] for s, i in picks})
    ref_genome = Genome.from_files(genome["fasta"], genome["gtf"])
    want = []
    for reads in samples:
        keys = sorted(reads)
        ref = Reference(ref_genome, cfg, [reads[k][1] for k in keys])
        want.append({k: ref.records(*reads[k]) for k in keys})
    out = []
    for seed, reads, got in zip(seeds, samples, want):
        ctl = check.judge(got, reads, ref_genome, cfg,
                          make=check.control_reference)
        out.append({"seed": seed, "checked_reads": ctl["checked_reads"],
                    "mismatched_reads": ctl["mismatched_reads"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.check import LIMIT_MISMATCHED

    t0 = time.time()
    for r in control_readings(ROOT, args.workload, args.batches, args.seeds):
        r["limit"] = LIMIT_MISMATCHED
        r["fails"] = r["mismatched_reads"] > LIMIT_MISMATCHED
        print(json.dumps(r), flush=True)
    print(f"control: {time.time() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
