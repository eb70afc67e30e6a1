"""Synthesize benchmark reads from the first chromosome of a FASTA.

90 bp windows with 0-3 substitutions, both strands (the draws of
``tools/workloads.py::read_draws``, with the first chromosome's case
folded).  Each read's name carries its true origin (0-based, half-open)
and strand, ``synth<i>:<chrom>:<start>:<end>:<+|->``, so the metrics
harness's truth mode has a referee that is not the aligner itself.

Usage:

    python -m thermite_tpu_torch.tools.make_reads REF.fasta N OUT.fastq [SEED]
        (SEED defaults to 7)
"""

from __future__ import annotations

import sys

from .workloads import read_draws


def write_reads(ref_path: str, n: int, out_path: str, seed: int = 7) -> None:
    from ..io.fastx import parse_fastx

    rec = next(iter(parse_fastx(ref_path)))
    cname = rec.id.split(b" ")[0].decode()
    with open(out_path, "w") as f:
        for i, (p, strand, r) in enumerate(read_draws(rec.seq.upper(), n, seed)):
            name = f"synth{i}:{cname}:{p}:{p + 90}:{strand}"
            f.write(f"@{name}\n{r.decode()}\n+\n{'I' * 90}\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    write_reads(argv[0], int(argv[1]), argv[2],
                int(argv[3]) if len(argv) > 3 else 7)
    return 0


if __name__ == "__main__":
    sys.exit(main())
