"""thermite command line of the PyTorch/CUDA port.

    python -m thermite_tpu_torch.cli index ref.fasta ref.gtf -o ref.tai.npz
    python -m thermite_tpu_torch.cli align ref.tai.npz reads.fq -a -o out.bam \\
        -k20 -s0 --intron-mode
    python -m thermite_tpu_torch.cli align ref.tai.npz r1.fq r2.fq --paired \\
        -a -o out.bam -k20 -s0 --intron-mode
    python -m thermite_tpu_torch.cli merge -o out.bam out.bam.shard000 ...

``index`` builds the ``Index`` artifact (the reference package's
format); it takes the reference CLI's ``--sa-sampling-rate`` and
``--occ-sampling-rate`` as no-ops.  ``align --engine batch`` (the
default) runs the port's batch pipeline on ``--device`` (``cuda`` by
default; a run without a card raises rather than falling back);
``--engine cpp`` the all-C++ host engine; ``--engine oracle`` the
sequential oracle.  ``--paired`` aligns two mate files.
``--num-hosts``/``--host-id`` align one contiguous block of the reads and
write ``OUTPUT.shardNNN``; ``merge`` joins the shards in host order.
``--coordinator HOST:PORT`` is accepted and not used: shards share
nothing, so one line on stderr says so and the run goes on.
``--mesh N`` spreads each chunk's extension problems over the first N
local devices of ``--device`` (``-1``: all of them; more than exist
raises); the bytes are those of one device.  ``--profile DIR`` runs under
``torch.profiler`` and writes one Chrome trace file into ``DIR``; the
output is unchanged.  ``-v`` is taken before or after the subcommand.
Flags and output formats match the reference CLI's: PAF by default,
``-a`` for SAM, or BAM when the output path ends in ``.bam``.

The batch engine reads ``THERMITE_NARROW_BAND`` (default 15; 0 = full
band), ``THERMITE_PROBLEM_BUDGET`` (problems a chunk, default 63488),
``THERMITE_PIPELINE_DEPTH`` (chunks in flight, default 2) and
``THERMITE_NO_EMIT`` (records through ``align_batch`` and the Python
writers instead of the C++ emitter; same bytes).
"""

from __future__ import annotations

import argparse
import gc
import os
import sys

from .constants import (
    DEFAULT_MIN_ALN_SCORE,
    DEFAULT_MIN_ALN_SCORE_PERCENT,
    DEFAULT_MIN_SEED_LEN,
    DEFAULT_MULTIMAP_SCORE_RANGE,
)


class _SubParser(argparse.ArgumentParser):
    """A subcommand's parser: takes ``-v`` too.  SUPPRESS keeps a ``-v``
    given before the subcommand from being reset by this default."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.add_argument("-v", "--verbose", action="store_true",
                          default=argparse.SUPPRESS)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="thermite", description="spliced RNA aligner (PyTorch/CUDA port)"
    )
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True, parser_class=_SubParser)

    pi = sub.add_parser("index", help="Index a reference")
    pi.add_argument("reference", help="reference FASTA")
    pi.add_argument("annotations", help="GTF annotations")
    pi.add_argument("-o", "--output", default="-", dest="index")
    # the reference CLI's flags: this index has no suffix array and no FM
    # Occ table to sample (the seed table's knob is --seed-stride), so
    # they are taken and not used
    pi.add_argument("--sa-sampling-rate", type=int, default=32,
                    help="accepted for CLI compatibility; not used")
    pi.add_argument("--occ-sampling-rate", type=int, default=128,
                    help="accepted for CLI compatibility; not used")
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
    pa.add_argument("--engine", choices=["oracle", "batch", "cpp"], default="batch",
                    help="batch = the CUDA pipeline; oracle = sequential "
                    "referee; cpp = all-C++ host engine (SAM/BAM only)")
    pa.add_argument("--batch-size", type=int, default=16384)
    pa.add_argument("--threads", type=int, default=0, metavar="N",
                    help="host threads of the C++ stages, of the cpp "
                    "engine's DP and of the BAM writer's deflate "
                    "(0 = THERMITE_THREADS, else all cores)")
    pa.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) or cpu (plain PyTorch kernels)")
    pa.add_argument("--paired", action="store_true",
                    help="the two query files are R1/R2 mates (SAM/BAM "
                    "output; pair flags, RNEXT/PNEXT/TLEN)")
    pa.add_argument("--max-insert", type=int, default=1000, metavar="N",
                    help="max template length for a proper pair (paired mode)")
    pa.add_argument("--no-mate-rescue", action="store_true",
                    help="do not search an unmapped mate inside its mapped "
                    "partner's insert window (paired mode)")
    pa.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the run "
                    "into DIR")
    pa.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="spread each chunk's problems over N local devices "
                    "of --device (0 = one device; -1 = every local device)")
    pa.add_argument("--num-hosts", type=int, default=1,
                    help="total aligner hosts; this host aligns its "
                    "contiguous block of the reads and writes OUTPUT.shardNNN")
    pa.add_argument("--host-id", type=int, default=None,
                    help="this host's rank in [0, num-hosts)")
    pa.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="accepted and not used: host shards share nothing")

    pm = sub.add_parser("merge", help="Merge per-host output shards (host "
                        "order) into one file")
    pm.add_argument("-o", "--output", required=True)
    pm.add_argument("shards", nargs="+")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    if args.cmd == "merge":
        from .parallel.multihost import merge_shards, sniff_shard_format

        ext = os.path.splitext(args.output)[1]
        fmt = ext[1:] if ext in (".bam", ".sam", ".paf") else \
            sniff_shard_format(args.shards[0])
        merge_shards(args.shards, args.output, fmt)
        return 0

    from .index.build import Index

    if args.cmd == "index":
        if args.index == "-":
            raise SystemExit("index output to stdout not supported; pass -o FILE")
        index = Index.create_from_files(args.reference, args.annotations)
        if args.verbose:
            index.print_stats()
        stride = args.seed_stride
        if stride is None:
            stride = 1 if len(index.seq) < (512 << 20) else 4
        index.build_seed_table(stride=stride)
        index.save(args.index)
        return 0

    if not 0.0 <= args.min_aln_score_percent <= 1.0:
        raise SystemExit("Min alignment score percent must be between 0.0 and 1.0!")

    from .align.driver import AlignOpts
    from .align.run import FORMAT_BAM, FORMAT_PAF, FORMAT_SAM, align_reads_from_file

    if args.bam:
        fmt = FORMAT_BAM if args.output.endswith(".bam") else FORMAT_SAM
    else:
        fmt = FORMAT_PAF
    # usage checks before the (possibly multi-GB) index load
    shard, output = None, args.output
    if args.num_hosts > 1:
        if args.host_id is None:
            raise SystemExit("--num-hosts requires --host-id")
        if not 0 <= args.host_id < args.num_hosts:
            raise SystemExit("--host-id must be in [0, num-hosts)")
        shard = (args.host_id, args.num_hosts)
        if args.coordinator:
            print(f"--coordinator {args.coordinator}: not used, host shards "
                  "need no coordinator (each aligns its block of the reads "
                  "on its own; join them with `merge`)", file=sys.stderr)
        if output != "-":
            output = f"{output}.shard{args.host_id:03d}"
    if args.paired:
        if len(args.queries) != 2:
            raise SystemExit("--paired requires exactly two query files (R1 R2)")
        if fmt == FORMAT_PAF:
            raise SystemExit("--paired writes SAM/BAM only (pass -a)")
    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh

        mesh = make_mesh(None if args.mesh < 0 else args.mesh, args.device)
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
    if args.paired:
        from .align.paired import align_paired_from_files

        align_paired_from_files(
            index, args.queries[0], args.queries[1], output, fmt, opts,
            engine=args.engine, batch_size=args.batch_size,
            max_insert=args.max_insert, verbose=args.verbose, shard=shard,
            mate_rescue=not args.no_mate_rescue, device=args.device,
            mesh=mesh, profile_dir=args.profile,
        )
        return 0
    align_reads_from_file(
        index, args.queries, output, fmt, opts, engine=args.engine,
        batch_size=args.batch_size, verbose=args.verbose, device=args.device,
        shard=shard, mesh=mesh, profile_dir=args.profile,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
