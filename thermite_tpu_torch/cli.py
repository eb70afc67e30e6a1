"""thermite command line of the PyTorch/CUDA port.

    python -m thermite_tpu_torch.cli index ref.fasta ref.gtf -o ref.tai.npz
    python -m thermite_tpu_torch.cli align ref.tai.npz reads.fq -a -o out.bam \\
        -k20 -s0 --intron-mode

``index`` builds the reference ``Index``.  ``align --engine batch`` (the
default) runs the port's batch pipeline on ``--device`` (``cuda`` by
default; a run without a card raises rather than falling back);
``--engine oracle`` runs the reference's sequential oracle.  Flags and
output formats match ``thermite_tpu.cli``: PAF by default, ``-a`` for
SAM, or BAM when the output path ends in ``.bam``.  Parts of the
reference CLI not yet ported raise NotImplementedError naming their
ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys

from thermite_tpu.constants import (
    DEFAULT_MIN_ALN_SCORE,
    DEFAULT_MIN_ALN_SCORE_PERCENT,
    DEFAULT_MIN_SEED_LEN,
    DEFAULT_MULTIMAP_SCORE_RANGE,
)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to thermite_tpu_torch yet (ROADMAP.md, {item})"
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="thermite", description="spliced RNA aligner (PyTorch/CUDA port)"
    )
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="Index a reference")
    pi.add_argument("reference", help="reference FASTA")
    pi.add_argument("annotations", help="GTF annotations")
    pi.add_argument("-o", "--output", required=True, dest="index")
    pi.add_argument("--seed-stride", type=int, default=None)

    pa = sub.add_parser("align", help="Align reads to an indexed reference")
    pa.add_argument("index")
    pa.add_argument("queries", nargs="+")
    pa.add_argument("-o", "--output", default="-")
    pa.add_argument("-k", "--min-seed-len", type=int, default=DEFAULT_MIN_SEED_LEN)
    pa.add_argument("-s", "--min-aln-score-percent", type=float,
                    default=DEFAULT_MIN_ALN_SCORE_PERCENT)
    pa.add_argument("--min-aln-score", type=int, default=DEFAULT_MIN_ALN_SCORE)
    pa.add_argument("--multimap-score-range", type=int,
                    default=DEFAULT_MULTIMAP_SCORE_RANGE)
    pa.add_argument("-a", dest="bam", action="store_true", help="SAM/BAM output")
    pa.add_argument("--intron-mode", action="store_true")
    pa.add_argument("--engine", choices=["oracle", "batch", "cpp"], default="batch")
    pa.add_argument("--batch-size", type=int, default=16384)
    pa.add_argument("--threads", type=int, default=0, metavar="N",
                    help="host threads of the C++ chunk build (0 = auto)")
    pa.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) or cpu (plain PyTorch kernels)")
    pa.add_argument("--paired", action="store_true")
    pa.add_argument("--mesh", type=int, default=0, metavar="N")
    pa.add_argument("--profile", default=None, metavar="DIR")

    pm = sub.add_parser("merge", help="Merge per-host output shards")
    pm.add_argument("-o", "--output", required=True)
    pm.add_argument("shards", nargs="+")

    args = p.parse_args(argv)

    if args.cmd == "merge":
        _not_ported("merge", "Queue 1, item 7a")

    from thermite_tpu.index.build import Index

    if args.cmd == "index":
        index = Index.create_from_files(args.reference, args.annotations)
        if args.verbose:
            index.print_stats()
        stride = args.seed_stride
        if stride is None:
            stride = 1 if len(index.seq) < (512 << 20) else 4
        index.build_seed_table(stride=stride)
        index.save(args.index)
        return 0

    if args.engine == "cpp":
        _not_ported("--engine cpp", "Queue 1, item 4")
    if args.paired:
        _not_ported("--paired", "Queue 1, item 5")
    if args.mesh:
        _not_ported("--mesh", "Queue 1, item 7b")
    if args.profile:
        _not_ported("--profile", "Queue 1, item 9")
    if not 0.0 <= args.min_aln_score_percent <= 1.0:
        raise SystemExit("Min alignment score percent must be between 0.0 and 1.0!")

    from thermite_tpu.align.driver import AlignOpts

    from .align.run import FORMAT_BAM, FORMAT_PAF, FORMAT_SAM, align_reads_from_file

    if args.bam:
        fmt = FORMAT_BAM if args.output.endswith(".bam") else FORMAT_SAM
    else:
        fmt = FORMAT_PAF
    if args.threads:
        os.environ["THERMITE_THREADS"] = str(args.threads)
    index = Index.load(args.index)
    if getattr(index, "seed_table", None) is not None and not isinstance(
        index.seed_table, tuple
    ):
        index.warm_mmap()  # genome-scale packed table: stream it in once
    gc.freeze()  # the loaded index is immortal; keep it out of the GC
    opts = AlignOpts(
        min_seed_len=args.min_seed_len,
        min_aln_score_percent=args.min_aln_score_percent,
        min_aln_score=args.min_aln_score,
        multimap_score_range=args.multimap_score_range,
        intron_mode=args.intron_mode,
    )
    align_reads_from_file(
        index, args.queries, args.output, fmt, opts, engine=args.engine,
        batch_size=args.batch_size, verbose=args.verbose, device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
