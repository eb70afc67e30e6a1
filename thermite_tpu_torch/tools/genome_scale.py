"""Whole-genome scale on the card: index and align a >= 3 Gbp genome.

Users align against GRCh38 (3.1 Gbp, 6.2 Gbp of fwd+rc text).  This
tool synthesizes a genome of that scale (16 chromosomes of 200 Mbp at
3.2 Gbp, spliced genes at chr21-like density, seed 2024), indexes it
with a stride-sampled seed table (the C++ ``thermite_seed_index_new_stride``;
stride 4 keeps one text position in four, as STAR's sparse suffix
array does), saves the artifact and aligns on its memory-mapped reload,
keeps the nibble-packed text resident on the card, aligns truth reads
(seed 31) through ``BatchAligner.align_batch`` and through the main
path ``align_batch_emit`` to BAM, scores the primary alignments against
the truth, and holds a sample of reads (rng seed 5) against the
sequential oracle.  It prints one JSON line.

Usage (on the card):

    python -m thermite_tpu_torch.tools.genome_scale [total_Gbp] [n_reads] [stride]
        (defaults 3.2 65536 4)
        --resume       load data/out/genome_scale/wg_index.npz instead of
                       building (after a crash past the build);
                       --table-s SECONDS carries the table build's time
        --fresh        synthesize the FASTA even if a matching one exists
        --no-artifact  align on the index in memory: no save, no reload

The artifact of a 3.2 Gbp genome is about 23 GB, and the FASTA 3.2 GB;
both go to data/out/genome_scale/.  The tool exits 1 when a sampled
read differs from the oracle.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "data", "out", "genome_scale")
N_WARM = 8192
N_SPOT = 300
N_TOP_THREADS = 8


def _log_stderr(msg: str) -> None:
    print(f"[genome_scale +{time.time() - _T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


_T0 = time.time()


def card_readings(dev) -> Dict[str, object]:
    """The card's name and power limit as nvidia-smi reads them."""
    import torch

    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    limit = line.split(",")[-1].strip() if "," in line else None
    return {"device": torch.cuda.get_device_name(dev), "power_limit": limit}


def stage_split(stats) -> Dict[str, float]:
    """``PipelineStats.split``: each top-level stage's host time, and
    the device wait + d2h of the stages that synchronize with the card."""
    return {k: round(v, 4) for k, v in stats.split().items()}


def _peak_rss() -> int:
    """The process's peak resident set so far, in bytes (Linux)."""
    import resource

    return 1024 * resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def _key(g):
    a = g.gx_aln
    return (g.ref_name, g.strand, a.ystart, a.yend, a.score, g.primary,
            a.operations)


def truth_overlap(reads, out) -> int:
    """Reads whose primary alignment overlaps the locus its name
    (``synth{i}:{chrom}:{start}:{end}:{strand}``) records."""
    ok = 0
    for (name, _), alns in zip(reads, out):
        _, chrom, s, e, strand = name.rsplit(":", 4)
        for ga in alns:
            if not ga.primary:
                continue
            if (ga.ref_name == chrom and ga.strand != (strand == "-")
                    and ga.gx_aln.ystart < int(e) and ga.gx_aln.yend > int(s)):
                ok += 1
            break
    return ok


def build_index(total_bp: int, stride: int, out_dir: str, *, resume=False,
                fresh=False, artifact=True, log: Callable = _log_stderr):
    """Synthesize (or reuse) the genome, index it, build the seed table
    and, with ``artifact``, save and reload the index memory-mapped.
    -> (index, total_bp, timings)."""
    from ..index.build import Index
    from ..testing.synth import write_synth_genome

    t = {"table_build_s": -1.0, "artifact_save_s": -1.0,
         "artifact_load_s": -1.0, "artifact_bytes": -1}
    art = os.path.join(out_dir, "wg_index.npz")
    if resume:
        log(f"resuming from artifact {art} "
            f"({os.path.getsize(art) / 1e9:.1f} GB)")
        t0 = time.time()
        idx = Index.load(art)
        t["artifact_load_s"] = time.time() - t0
        t["artifact_bytes"] = os.path.getsize(art)
        log(f"artifact reloaded in {t['artifact_load_s']:.1f} s; mmap "
            f"members warmed in {idx.warm_mmap():.1f} s")
        return idx, sum(r.len for r in idx.refs if r.strand), t

    n_chroms = max(total_bp // 200_000_000, 1)
    fasta = os.path.join(out_dir, "wg.fasta")
    gtf = os.path.join(out_dir, "wg.gtf")
    # the generator is seed-deterministic: a wg.fasta whose size matches
    # THIS total_bp (bases + per-chromosome header and newline) is this
    # genome; a file of another scale is never reused
    sz = os.path.getsize(fasta) if os.path.exists(fasta) else -1
    t0 = time.time()
    if (total_bp <= sz <= int(total_bp * 1.01) + 4096
            and os.path.exists(gtf) and not fresh):
        log(f"reusing existing {fasta}")
    else:
        log(f"synthesizing {total_bp / 1e9:.3f} Gbp across {n_chroms} "
            "chromosomes")
        fasta, gtf = write_synth_genome(out_dir, total_bp, seed=2024,
                                        n_chroms=n_chroms, basename="wg")
    t["synth_s"] = time.time() - t0
    t0 = time.time()
    idx = Index.create_from_files(fasta, gtf)
    t["index_s"] = time.time() - t0
    log(f"parsed + concatenated (fwd+rc) in {t['index_s']:.1f} s: text "
        f"{len(idx.seq) / 1e9:.3f} G, {len(idx.txome.txs)} transcripts; "
        f"building the stride-{stride} seed table")
    t0 = time.time()
    idx.build_seed_table(stride=stride)
    t["table_build_s"] = time.time() - t0
    st = idx.seed_table
    npos = len(st.kv) if hasattr(st, "kv") else len(st[3])
    t["table_positions"] = int(npos)
    log(f"seed table built in {t['table_build_s']:.1f} s "
        f"({npos / 1e9:.3f} G positions, {type(st).__name__})")
    if artifact:
        # the alignment below runs on the RELOADED index: the save/load
        # path a user takes at scale
        t0 = time.time()
        idx.save(art)
        t["artifact_save_s"] = time.time() - t0
        t["artifact_bytes"] = os.path.getsize(art)
        log(f"artifact saved in {t['artifact_save_s']:.1f} s "
            f"({t['artifact_bytes'] / 1e9:.2f} GB)")
        del idx, st
        t0 = time.time()
        idx = Index.load(art, mmap=True)
        t["artifact_load_s"] = time.time() - t0
        log(f"artifact reloaded in {t['artifact_load_s']:.1f} s; mmap "
            f"members warmed in {idx.warm_mmap():.1f} s")
    return idx, total_bp, t


def run_genome_scale(total_bp: int, n_reads: int, stride: int = 4,
                     out_dir: str = OUT_DIR, device="cuda", *,
                     resume: bool = False, table_s: Optional[float] = None,
                     fresh: bool = False, artifact: bool = True,
                     n_spot: int = N_SPOT, n_warm: int = N_WARM,
                     log: Callable = _log_stderr,
                     keep: Optional[dict] = None) -> dict:
    """The whole run; -> the result dict (the JSON line).  ``keep``, when
    given, receives the index, options, aligner and reads for further
    checks by the caller."""
    import torch

    from ..align.batch import BatchAligner
    from ..align.driver import AlignOpts, OracleAligner
    from ..device import resolve
    from ..testing.synth import make_truth_reads
    from .thread_tax import format_rows, thread_tax

    dev = resolve(device)
    os.makedirs(out_dir, exist_ok=True)
    idx, total_bp, t = build_index(total_bp, stride, out_dir, resume=resume,
                                   fresh=fresh, artifact=artifact, log=log)
    if table_s is not None:
        t["table_build_s"] = table_s
    text_len = len(idx.seq)

    opts = AlignOpts(min_seed_len=20, min_aln_score_percent=0.0,
                     min_aln_score=30, intron_mode=True)
    reads = make_truth_reads(idx, n_reads, seed=31)
    seqs = [r[1] for r in reads]
    recs = [(n.encode(), s, b"I" * len(s)) for n, s in reads]

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    t0 = time.time()
    batch = BatchAligner(idx, opts, device=dev)
    engine_s = time.time() - t0
    log(f"BatchAligner (seeder, C++ engine) in {engine_s:.1f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    text_dev = batch._ref_text()[0]  # host nibble pack + upload, timed apart
    sync()
    up_s = time.time() - t0
    pack_s = batch.stats.stage_s.get("text pack", 0.0)
    copy_s = batch.stats.stage_s.get("text upload", 0.0)
    text_dev_bytes = text_dev.numel() * text_dev.element_size()
    log(f"resident text ({text_dev_bytes / 1e9:.3f} GB) packed and uploaded "
        f"in {up_s:.1f} s (pack {pack_s:.1f} s, copy to the card "
        f"{copy_s:.1f} s)")

    # warm both entry points: first launches, shape buckets, and the
    # engine's output string tables (loaded at the first emit)
    t0 = time.time()
    batch.align_batch(seqs[:n_warm])
    batch.align_batch_emit(recs[:n_warm], True)
    sync()
    log(f"warm-up ({min(n_warm, len(seqs))} reads, both entry points) "
        f"{time.time() - t0:.1f} s")

    batch.stats.reset()
    t0 = time.time()
    out = batch.align_batch(seqs)
    sync()
    run_s = time.time() - t0
    rps = len(seqs) / run_s
    mapped = sum(1 for o in out if o)
    stages = stage_split(batch.stats)
    cert = batch.stats.cert_patches
    log(f"align_batch: {len(seqs)} reads in {run_s:.2f} s = {rps:.1f} "
        f"reads/s ({mapped / len(seqs):.4f} mapped)")
    log(batch.stats.report())

    # the main path: BAM records through the C++ emit, with the CPU
    # seconds of every thread
    from ..ops.swg_stream import swg_stream, swg_stream_wide

    n0 = swg_stream.launches + swg_stream_wide.launches
    batch.stats.reset()
    bam, bam_s, rows = thread_tax(
        lambda: (batch.align_batch_emit(recs, True), sync())[0])
    launches = swg_stream.launches + swg_stream_wide.launches - n0
    bam_stages = stage_split(batch.stats)
    log(f"align_batch_emit (BAM): {len(recs)} reads in {bam_s:.2f} s = "
        f"{len(recs) / bam_s:.1f} reads/s, {len(bam)} bytes, "
        f"{launches} stream-kernel launches")
    log(batch.stats.report())
    for ln in format_rows(rows, bam_s, N_TOP_THREADS):
        log(ln)

    ok = truth_overlap(reads, out)
    log(f"truth overlap (primary): {ok / len(reads):.4f}")

    log(f"spot parity vs the CPU oracle on {n_spot} reads")
    oracle = OracleAligner(idx, opts)
    spot = np.random.default_rng(5).choice(len(seqs), min(n_spot, len(seqs)),
                                           replace=False)
    mismatch = sum(
        [_key(g) for g in oracle.align_read(seqs[i])]
        != [_key(g) for g in out[i]] for i in spot)
    log(f"oracle spot check: {len(spot) - mismatch}/{len(spot)} identical")

    result = {
        "metric": "e2e_align_reads_per_s_wholegenome",
        "genome_bp": int(total_bp),
        "text_bytes": int(text_len),
        "seed_stride": int(stride),
        "value": round(rps, 1),
        "unit": "reads/s",
        "mapped_fraction": round(mapped / len(seqs), 4),
        "truth_overlap_primary": round(ok / len(reads), 4),
        "oracle_spot_mismatches": int(mismatch),
        "table_build_s": round(t["table_build_s"], 1),
        "text_upload_s": round(up_s, 3),
        "artifact_save_s": round(t["artifact_save_s"], 1),
        "artifact_load_s": round(t["artifact_load_s"], 1),
        # the port's own readings
        **card_readings(dev),
        "artifact_bytes": int(t["artifact_bytes"]),
        "n_reads": len(seqs),
        "oracle_spot_reads": len(spot),
        "synth_s": round(t.get("synth_s", -1.0), 1),
        "index_s": round(t.get("index_s", -1.0), 1),
        "table_positions": t.get("table_positions", -1),
        "engine_s": round(engine_s, 1),
        "resident_text_bytes": int(text_dev_bytes),
        "text_pack_s": round(pack_s, 3),
        "text_copy_s": round(copy_s, 3),
        "host_peak_rss_bytes": _peak_rss(),
        "max_memory_allocated": int(torch.cuda.max_memory_allocated(dev))
        if dev.type == "cuda" else None,
        "stages": stages,
        "cert_patches": int(cert),
        "bam_reads_per_s": round(len(recs) / bam_s, 1),
        "bam_bytes": len(bam),
        "bam_stages": bam_stages,
        "bam_stream_launches": int(launches),
        "bam_threads": [
            {"comm": c, "tid": tid, "cpu_s": round(d, 3),
             "main": tid == os.getpid()}
            for d, tid, c in rows[:N_TOP_THREADS]],
        "bam_thread_cpu_s": round(sum(r[0] for r in rows), 3),
    }
    with open(os.path.join(out_dir, "genome_scale.json"), "w") as f:
        json.dump(result, f)
    if keep is not None:
        keep.update(index=idx, opts=opts, aligner=batch, recs=recs, bam=bam)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m thermite_tpu_torch.tools.genome_scale",
        description="Index and align a synthetic whole genome on the card.")
    ap.add_argument("total_gbp", nargs="?", type=float, default=3.2)
    ap.add_argument("n_reads", nargs="?", type=int, default=65536)
    ap.add_argument("stride", nargs="?", type=int, default=4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--table-s", type=float, default=None)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--no-artifact", action="store_true")
    a = ap.parse_args(argv)
    result = run_genome_scale(
        int(a.total_gbp * 1e9), a.n_reads, a.stride, resume=a.resume,
        table_s=a.table_s, fresh=a.fresh, artifact=not a.no_artifact)
    print(json.dumps(result), flush=True)
    return 1 if result["oracle_spot_mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
