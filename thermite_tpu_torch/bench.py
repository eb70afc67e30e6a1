"""Headline benchmark of the port: the repository's ``bench.py`` on the card.

    python -m thermite_tpu_torch.bench                # one card, cuda:0
    python -m thermite_tpu_torch.bench --device cpu --reads 512 --trials 2

The workload and the method are the repository bench's: 90 bp reads with
0-3 substitutions on both strands (``tools/workloads.py``), aligned at
``-k20 -s0 --intron-mode`` against the cached 45 Mbp synthetic chromosome
(``data/out/bench_syn45.npz``) by ``BatchAligner(index, opts, device)``,
the main path: the C++ engine, bands narrowed to 15, the packed stream
kernel.  Every trial's reads are made before the clock starts, the
pipeline's stats are reset after a warm-up batch (which also builds the
kernels at first use), and the headline ``value`` is the median reads/s
of ``align_batch`` over the trials, each trial's clock stopping after a
``torch.cuda.synchronize()`` on a card.  ``vs_baseline`` divides it by
the sequential Python oracle's reads/s on the same index, and
``vs_cpp_baseline`` by the same run's C++ engine on one thread.  The
other keys are the BAM emit and paired emit paths, the spread, and
effective and full-band-equivalent GCUPS.  The chrM keys are ``null``
when GRCh38 chrM (``workloads.CHRM_FASTA``) is absent.

The last line of standard output is one JSON object with the keys of the
repository bench's line.  Exit codes: 0 done; 3 the card did not come up
within ``PROBE_TIMEOUT_S`` or failed (the outage line, ``value`` 0, is
printed); 4 the whole run passed ``BENCH_DEADLINE_S`` seconds (default
2700; the partial line is printed); any other non-zero code a failure
(an engine or kernel that does not build or launch, a workload check).
Without ``--device cpu`` it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

from .tools import workloads

METRIC = "e2e_align_reads_per_s_syn45Mbp_90bp"
N_READS = 49152  # reads a trial: about 6 pipeline chunks, as the reference
TRIALS = 5
PROBE_TIMEOUT_S = 300.0
# the repository bench's line (bench.py:379-404), in its order
SYN45_KEYS = (
    "metric", "value", "unit", "vs_baseline", "vs_cpp_baseline", "trials",
    "syn45_spread_reads_per_s", "syn45_gcups_effective",
    "syn45_gcups_fullband_equiv", "syn45_oracle_reads_per_s",
    "syn45_cpp_1core_reads_per_s", "syn45_emit_bam_reads_per_s",
    "syn45_paired_emit_reads_per_s",
)
CHRM_KEYS = (
    "chrM_median_reads_per_s", "chrM_spread_reads_per_s",
    "chrM_gcups_effective", "chrM_vs_oracle", "chrM_vs_cpp",
    "chrM_cpp_1core_reads_per_s", "chrM_emit_bam_reads_per_s",
    "chrM_default_cfg_reads_per_s",
)


def _require(cond: bool, msg: str) -> None:
    """A workload check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def records(reads):
    """The (name, seq, qual) records the emit and C++ timers align."""
    return [(b"r%d" % i, r, b"I" * len(r)) for i, r in enumerate(reads)]


def oracle_rps(index, opts, reads, passes: int = 2) -> float:
    """The sequential oracle's reads/s, best of ``passes``."""
    from .align.driver import OracleAligner

    oracle = OracleAligner(index, opts)
    best = 0.0
    for _ in range(passes):
        t0 = time.perf_counter()
        for r in reads:
            oracle.align_read(r)
        best = max(best, len(reads) / (time.perf_counter() - t0))
    return best


def cpp_rps(index, opts, reads, passes: int = 3) -> float:
    """The all-C++ engine on one thread (``align/cpu.py``: seeding,
    full-band scalar SWG, arbitration, finalize and SAM emit), reads/s,
    best of ``passes``.  An engine that does not build raises."""
    from .align.cpu import CppAligner

    cpp = CppAligner(index, opts, threads=1)
    recs = records(reads)
    best = 0.0
    for _ in range(passes):
        t0 = time.perf_counter()
        raw = cpp.align_records(recs, False)
        best = max(best, len(recs) / (time.perf_counter() - t0))
    _require(len(raw) > 40 * len(recs), "C++ engine: too few SAM bytes")
    return best


def _timed(run, device) -> tuple:
    """(seconds, result) of ``run()``, the clock stopping after a
    synchronize of ``device`` when it is a card."""
    out = []
    return workloads.timed(lambda: out.append(run()), device), out[0]


def steady_state(batch, make_trial_reads, n_trials: int):
    """Median, min and max reads/s of ``align_batch`` over ``n_trials``
    trials (every trial's reads made first, stats reset), and effective
    and full-band-equivalent GCUPS over their wall; raises AssertionError
    when 90% of the last trial's reads or fewer mapped, or when the
    packed stream kernel did not launch on a card."""
    from .ops.swg_stream import swg_stream

    trial_reads = [make_trial_reads(t) for t in range(n_trials)]
    rps, wall, out = [], 0.0, None
    batch.stats.reset()
    launches = swg_stream.launches
    for reads in trial_reads:
        dt, out = _timed(lambda: batch.align_batch(reads), batch.device)
        wall += dt
        rps.append(len(reads) / dt)
    _require(out is not None and sum(1 for o in out if o) > 0.9 * len(out),
             "mapping rate sanity")
    if batch.device.type == "cuda":
        _require(swg_stream.launches - launches >= batch.stats.chunks > 0,
                 f"swg_stream launched {swg_stream.launches - launches} "
                 f"times for {batch.stats.chunks} chunks")
    return (statistics.median(rps), min(rps), max(rps),
            batch.stats.dp_cells / wall / 1e9,
            batch.stats.dp_cells_ref / wall / 1e9)


def _best_of_3(run, n: int, device) -> tuple:
    """Best reads/s of three ``run()`` calls over ``n`` reads, and the
    last call's bytes."""
    best = 0.0
    for _ in range(3):
        dt, raw = _timed(run, device)
        best = max(best, n / dt)
    return best, raw


def emit_rps(batch, reads) -> float:
    """Reads/s of ``align_batch_emit`` to BAM record bytes (the CLI's
    path), best of 3 after a warm-up on the first 2048 records."""
    recs = records(reads)
    batch.align_batch_emit(recs[:2048], True)
    best, raw = _best_of_3(lambda: batch.align_batch_emit(recs, True),
                           len(recs), batch.device)
    _require(len(raw) > 50 * len(recs), "emit: too few BAM bytes")
    return best


def paired_rps(batch, chrom: bytes, n_pairs: int, seed: int = 51) -> float:
    """Reads/s (both mates) of ``align_paired_emit`` to BAM on FR pairs
    (``workloads.fr_pairs``), best of 3 after a warm-up on 1024 pairs."""
    pairs = workloads.fr_pairs(chrom, n_pairs, seed)
    batch.align_paired_emit(pairs[:1024], True)
    best, raw = _best_of_3(lambda: batch.align_paired_emit(pairs, True),
                           2 * len(pairs), batch.device)
    _require(len(raw) > 100 * len(pairs), "paired emit: too few BAM bytes")
    return best


def run(index, opts, device="cuda", n_reads: int = N_READS,
        trials: int = TRIALS, partial: dict | None = None) -> dict:
    """The syn45 section on ``index``: the ``SYN45_KEYS`` of the bench's
    line.  ``partial`` (if given) receives each reading as it
    is taken, for the deadline's line."""
    from .align.batch import BatchAligner

    partial = {} if partial is None else partial
    make_reads, chrom = workloads.make_reads, workloads.first_chrom(index)
    oracle = oracle_rps(index, opts, make_reads(chrom, 192, seed=11))
    cpp = cpp_rps(index, opts, make_reads(chrom, 4096, seed=13))
    _log(f"syn45 C++ 1-core baseline: {cpp:.1f} reads/s")
    partial["syn45_oracle_reads_per_s"] = round(oracle, 1)
    partial["syn45_cpp_1core_reads_per_s"] = round(cpp, 1)

    batch = BatchAligner(index, opts, device=device)
    warm = workloads.timed(
        lambda: batch.align_batch(make_reads(chrom, n_reads, seed=12)),
        batch.device)
    _log(f"warm-up batch (kernels built at first use): {warm:.1f} s")
    med, lo, hi, gcups, gcups_ref = steady_state(
        batch, lambda t: make_reads(chrom, n_reads, seed=20 + t), trials)
    _log(batch.stats.report())
    _log(f"syn45 oracle baseline: {oracle:.1f} reads/s")
    partial["syn45_median"] = round(med, 1)
    emit = emit_rps(batch, make_reads(chrom, n_reads, seed=33))
    partial["syn45_emit_bam_reads_per_s"] = round(emit, 1)
    paired = paired_rps(batch, chrom, n_reads // 2)
    partial["syn45_paired_emit_reads_per_s"] = round(paired, 1)
    return dict(zip(SYN45_KEYS, (
        METRIC, round(med, 1), "reads/s", round(med / oracle, 2),
        round(med / cpp, 2), trials, [round(lo, 1), round(hi, 1)],
        round(gcups, 2), round(gcups_ref, 2), round(oracle, 1),
        round(cpp, 1), round(emit, 1), round(paired, 1),
    )))


def chrm(device="cuda", n_reads: int = N_READS, trials: int = TRIALS,
         partial: dict | None = None) -> dict:
    """The chrM section (GRCh38 chrM, then the same reads at ``-s0.66``
    over 3 trials): the ``CHRM_KEYS`` of the line, all ``None`` when
    ``workloads.CHRM_FASTA`` is absent."""
    from .align.batch import BatchAligner

    if not os.path.exists(workloads.CHRM_FASTA):
        _log(f"chrM FASTA not found: {workloads.CHRM_FASTA}; the chrM keys "
             "are null")
        return dict.fromkeys(CHRM_KEYS)
    partial = {} if partial is None else partial
    index, opts = workloads.chrm_index(), workloads.bench_opts()
    make_reads, chrom = workloads.make_reads, workloads.first_chrom(index)
    oracle = oracle_rps(index, opts, make_reads(chrom, 256, seed=11))
    cpp = cpp_rps(index, opts, make_reads(chrom, 4096, seed=13))
    _log(f"chrM C++ 1-core baseline: {cpp:.1f} reads/s")
    batch = BatchAligner(index, opts, device=device)
    batch.align_batch(make_reads(chrom, n_reads, seed=12))
    med, lo, hi, gcups, _ = steady_state(
        batch, lambda t: make_reads(chrom, n_reads, seed=20 + t), trials)
    _log(batch.stats.report())
    _log(f"chrM oracle baseline: {oracle:.1f} reads/s")
    partial["chrM_median_reads_per_s"] = round(med, 1)
    emit = emit_rps(batch, make_reads(chrom, n_reads, seed=33))

    bdef = BatchAligner(index, workloads.bench_opts(0.66), device=device)
    bdef.align_batch(make_reads(chrom, n_reads, seed=12))
    def_rps = steady_state(
        bdef, lambda t: make_reads(chrom, n_reads, seed=40 + t), 3)[0]
    return dict(zip(CHRM_KEYS, (
        round(med, 1), [round(lo, 1), round(hi, 1)], round(gcups, 2),
        round(med / oracle, 2), round(med / cpp, 2), round(cpp, 1),
        round(emit, 1), round(def_rps, 1),
    )))


def _outage(reason: str) -> None:
    """Print the outage line and exit 3 (``os._exit``: a probe thread
    may still hang in CUDA's initialisation).  With chrM present the line also
    carries its C++ and oracle baselines, which need no card."""
    extra = {}
    if os.path.exists(workloads.CHRM_FASTA):
        try:
            index, opts = workloads.chrm_index(), workloads.bench_opts()
            chrom = workloads.first_chrom(index)
            extra["chrM_cpp_1core_reads_per_s"] = round(cpp_rps(
                index, opts, workloads.make_reads(chrom, 4096, seed=13)), 1)
            extra["chrM_oracle_reads_per_s"] = round(oracle_rps(
                index, opts, workloads.make_reads(chrom, 192, seed=11)), 1)
        except Exception as e:  # the outage line matters more than these
            _log(f"bench: chrM baselines failed: {e!r}")
    print(json.dumps({"metric": METRIC, "value": 0, "unit": "reads/s",
                      "vs_baseline": 0, "error": reason,
                      "backend_outage": True, **extra}), flush=True)
    os._exit(3)


def require_device(device, timeout_s: float = PROBE_TIMEOUT_S) -> None:
    """Bring up the card (``torch.cuda.is_available()`` and one small
    tensor on it) in a thread within ``timeout_s``; on a hang or an
    error print the outage line and exit 3.  Logs the card's name and
    power limit.  ``cpu`` is taken as asked, with no probe."""
    import torch

    if torch.device(device).type != "cuda":
        _log(f"bench: device {device}, as asked")
        return
    done, state = threading.Event(), {}

    def probe():
        try:
            if not torch.cuda.is_available():
                raise RuntimeError("torch.cuda.is_available() is False")
            torch.ones(1, device=device).sum().item()
            state["name"] = torch.cuda.get_device_name(torch.device(device))
        except Exception as e:  # reported as the outage's reason
            state["error"] = e
        done.set()

    threading.Thread(target=probe, daemon=True).start()
    if not done.wait(timeout_s):
        _log(f"bench: the card did not come up within {timeout_s:.0f} s")
        _outage(f"device init hang > {timeout_s:.0f}s")
    if "error" in state:
        _log(f"bench: device init failed: {state['error']!r}")
        _outage(f"device init failed: {type(state['error']).__name__}: "
                f"{state['error']}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi failed: {e!r}"
    _log(f"bench: nvidia-smi name,power.limit: {smi}")
    _log(f"bench: device {device}: {state['name']}, torch {torch.__version__}"
         f" cuda {torch.version.cuda}")


def start_watchdog(deadline_s: float, partial: dict) -> threading.Timer:
    """After ``deadline_s`` seconds print the partial line (the median
    if it was taken, and every reading in ``partial``) and exit 4."""
    def fire():
        print(json.dumps({
            "metric": METRIC, "value": partial.get("syn45_median", 0),
            "unit": "reads/s", "vs_baseline": 0,
            "error": f"bench deadline {deadline_s:.0f}s exceeded",
            "backend_outage": True, **partial,
        }), flush=True)
        os._exit(4)

    timer = threading.Timer(deadline_s, fire)
    timer.daemon = True
    timer.start()
    return timer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m thermite_tpu_torch.bench",
        description="The repository bench's line for the port: syn45 (and "
                    "chrM where its FASTA is present) through BatchAligner.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs only when asked")
    ap.add_argument("--reads", type=int, default=N_READS,
                    help=f"reads a trial (default {N_READS})")
    ap.add_argument("--trials", type=int, default=TRIALS,
                    help=f"timed trials (default {TRIALS})")
    args = ap.parse_args(argv)

    require_device(args.device)
    partial: dict = {}
    watchdog = start_watchdog(
        float(os.environ.get("BENCH_DEADLINE_S", "2700")), partial)
    try:
        index = workloads.syn45_index()
        line = run(index, workloads.bench_opts(), args.device, args.reads,
                   args.trials, partial)
        line.update(chrm(args.device, args.reads, args.trials, partial))
    finally:
        watchdog.cancel()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
