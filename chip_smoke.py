#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (thermite_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # phases 1, 2, 2b and 2c

Phases, each printed with its own timing; any failure exits non-zero
before the result lines are printed:

1. require CUDA; print the card's name and power limit; build the three
   CUDA kernels (one nvcc each, in parallel, sm_90a) and the C++ host
   engine (g++); print the registers and spills of every kernel.
2. swg_stream's packed kernel (bands <= 31) == swg_stream_plain
   (bit-exact, tolerance 0) on the same CUDA inputs: fuzz shapes for both
   band classes and meta forms, the narrow-band certificate shapes, and
   one full main-path chunk shape (65536 rows, XMAX 96, YMAX 128,
   band <= 15, SMAX 208), with both times.
2b. the general-band stream kernel (swg_stream_wide) == swg_stream_plain,
   bit-exact: fuzz shapes at bands <= 63, <= 127 and <= 255 in both meta
   forms (windows up to 512 for the widest), bands above XMAX (up to
   1023 slots), and the full-band chunk shape (65536 rows, XMAX 96,
   YMAX 160, band 60, SMAX 256), with both times.
2c. the forward-scores kernel (swg_forward) == swg_forward_plain,
   bit-exact, on the same kinds of shapes, with both times at the
   full-band chunk shape.
3. syn45 in memory: a 45 Mbp synthetic spliced chromosome, indexed, and
   49152 truth reads through BatchAligner(device="cuda")
   .align_batch_emit(fmt_bam=True); asserts the packed kernel ran once
   per chunk or more and that more than 90% of reads mapped.
3b. the same reads at full band (narrow_band 0): the BAM bytes equal
   phase 3's, the general-band kernel ran once per chunk or more and the
   packed kernel never; reads/s over 5 runs and the stage split.
3c. the path without the C++ engine (use_native=False) on the first 4096
   reads: the BAM bytes equal the C++ engine's on those reads; the
   forward-scores and general-band kernels each ran once per chunk or
   more.
4. C++ referee: every row of one syn45 chunk that the kernel certified
   equals the full-band scalar SWG of the C++ engine (native.patch_rows).
5. oracle referee: the SAM records of the first 200 reads equal the
   reference OracleAligner's through the reference SAM writers.
6. the user entry points: the index saved and loaded, and the port's CLI
   aligning 2000 reads to SAM, equal to the in-memory emit.

The last lines are one JSON object of kernel records and one JSON object
naming the device.  Nothing of JAX is imported.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SYN_BP = 45_000_000
N_READS = 49152
N_ORACLE = 200
N_NO_NATIVE = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# synthetic extension problems (numpy, seeded)


def _text_reads(rng, text_len, n_reads, rpad, read_len, indel_every=0):
    """ACGT text with a few N, and reads copied from it with 0-3
    substitutions (some non-ACGTN bytes) and, every `indel_every`-th
    read, a 25-base deletion; -> (text, reads (n, rpad), source pos)."""
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), text_len)
    text[rng.integers(0, text_len, max(text_len // 250, 1))] = ord("N")
    reads = np.zeros((n_reads, rpad), np.uint8)
    src = rng.integers(200, text_len - 400 - read_len, n_reads)
    for i in range(n_reads):
        p = int(src[i])
        r = text[p : p + read_len].copy()
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, read_len))] = ord("ACGTNX"[int(rng.integers(0, 6))])
        if indel_every and i % indel_every == 0:
            cut = int(rng.integers(20, read_len - 30))
            r = np.concatenate([r[:cut], text[p + cut + 25 : p + 25 + read_len]])
        reads[i, :read_len] = r[:read_len]
    return text, reads, src


def fuzz_problems(seed, n, band_max, XMAX=64, YMAX=96, band_min=0):
    """The reference's kernel fuzz shapes (by default XMAX 64, YMAX 96):
    random windows in both directions, some running into the padding,
    bands drawn from [band_min, band_max]; reads are RPAD = XMAX wide."""
    from thermite_tpu_torch.ops.layout import meta_row

    rng = np.random.default_rng(seed)
    RPAD = XMAX
    text, reads, src = _text_reads(rng, 5000 + 2 * YMAX, 32, RPAD, RPAD)
    rows = []
    for _ in range(n):
        band = int(rng.integers(band_min, band_max + 1))
        xd = int(rng.integers(1, 40))
        q = int(rng.integers(0, RPAD - 1))
        xdir = 1 if rng.random() < 0.5 else -1
        xlen = int(rng.integers(1, XMAX + 1))
        xlen = min(xlen, RPAD - q) if xdir == 1 else min(xlen, q + 1)
        ri = int(rng.integers(0, len(reads)))
        if rng.random() < 0.5:  # y where the read came from: long walks
            p, ydir = int(src[ri]) + q + int(rng.integers(-3, 4)), xdir
        else:
            p = int(rng.integers(0, len(text)))
            ydir = 1 if rng.random() < 0.5 else -1
        ylen = int(rng.integers(1, YMAX + 1))
        if rng.random() < 0.8:
            ylen = max(min(ylen, len(text) - p if ydir == 1 else p + 1), 1)
        rows.append(meta_row(p, ydir, ylen, ri * RPAD + q, xdir, xlen, band, xd))
    return text, reads, np.asarray(rows, np.int32), XMAX, YMAX


def chunk_problems(seed, n, wide=60, narrow=15):
    """Main-path chunk shape: 90 bp flanks built at band `wide` (some
    reads carry a 25-base deletion) and narrowed to `narrow`, as
    BatchAligner._narrow_meta submits them (narrow == wide: the full-band
    path's chunk)."""
    from thermite_tpu_torch.ops.layout import meta_row

    rng = np.random.default_rng(seed)
    RPAD = 96
    text, reads, src = _text_reads(rng, 1 << 20, 4096, RPAD, 90, indel_every=8)
    meta = np.zeros((n, 9), np.int32)
    xlen = rng.integers(1, 91, n)
    ri = rng.integers(0, len(reads), n)
    d = np.where(rng.random(n) < 0.5, 1, -1)
    for i in range(n):
        q = int(rng.integers(0, 91 - xlen[i]))
        if d[i] < 0:  # a left flank: both windows end at q + xlen - 1
            q += int(xlen[i]) - 1
        meta[i] = meta_row(int(src[ri[i]]) + q, int(d[i]),
                           min(int(xlen[i]) + wide + 1, 200),
                           int(ri[i]) * RPAD + q, int(d[i]), int(xlen[i]),
                           wide, wide)
    np.minimum(meta[:, 7], narrow, out=meta[:, 7])
    np.minimum(meta[:, 3], meta[:, 6] + meta[:, 7] + 1, out=meta[:, 3])
    return text, reads, meta, 96, 32 * ((90 + narrow + 1 + 31) // 32)


def _to_dev(text, reads, meta, dev):
    import torch

    from thermite_tpu_torch.ops.layout import pack_reads_nib_host, pack_text_nib_host

    words = torch.from_numpy(pack_text_nib_host(text)).to(dev)
    rnib = torch.from_numpy(pack_reads_nib_host(reads.reshape(-1))).to(dev)
    return words, rnib, torch.from_numpy(np.ascontiguousarray(meta)).to(dev)


def compare_kernel(args, reps, kernel, plain=None):
    """A kernel's wrapper and its plain version on the same CUDA inputs
    -> (rows that differ, max_abs_err, kernel ms or None, plain ms, the
    kernel's output rows on the host).  Stream outputs (hdr, streams)
    are compared as one row of int32 words."""
    import torch

    from thermite_tpu_torch.ops.swg_stream import swg_stream_plain

    plain = plain or swg_stream_plain

    def rows(out):
        return torch.cat(out, 1) if isinstance(out, tuple) else out

    got = rows(kernel(*args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rows(plain(*args))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    nbad = int((got != want).any(1).sum())
    ms = None
    if reps:
        start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(reps):
            kernel(*args)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / reps
    return nbad, err, ms, plain_ms, got.cpu().numpy()


def _nsteps(rows: np.ndarray) -> np.ndarray:
    """nsteps of split stream rows (int16 halves in the first 2 words)."""
    return np.ascontiguousarray(rows[:, :2]).view(np.int16)[:, 3]


def run_cases(dev, cases, kernel, plain=None, stream=True):
    """Each case through compare_kernel (the 65536-row ones timed), the
    kernel's wrapper given the case's band bound as the batch pipeline
    gives it (no device read per launch); -> (worst max_abs_err, (ms,
    plain_ms) of the last timed case)."""
    import torch

    from thermite_tpu_torch.ops.swg_stream import meta9

    worst, timing = 0, (None, None)
    for name, t, r, m, xm, ym, extra in cases:
        words, rnib, mt = _to_dev(t, r, m, dev)
        bmax = int(meta9(torch.from_numpy(np.ascontiguousarray(m)))[:, 7].max())
        nbad, err, ms, plain_ms, got = compare_kernel(
            (words, words.shape[0], rnib, mt, xm, ym, *extra),
            reps=20 if len(m) == 65536 else 0,
            kernel=functools.partial(kernel, band_max=bmax), plain=plain,
        )
        timing = (ms, plain_ms) if ms is not None else timing
        info = f"XMAX {xm} YMAX {ym}"
        if stream:
            ns = _nsteps(got)
            info += (f" SMAX {extra[0]}, certified {(ns >= 0).sum()}, cert "
                     f"failures {(ns <= -2).sum()}, bad walks {(ns == -1).sum()}")
        else:
            info += f", best score {got[:, 0].max()}"
        t_ms = f", kernel {ms:.4f} ms, plain {plain_ms:.1f} ms" if ms else ""
        log(f"  {name}: {len(m)} rows, {info}; {nbad} differ, "
            f"max_abs_err {err}{t_ms}")
        check(nbad == 0, f"kernel != plain on {name}")
        if name.startswith("certificate"):
            check((_nsteps(got) <= -2).any(),
                  "certificate shapes produced no -2-c rows")
        worst = max(worst, err)
    return worst, timing


def both_meta_forms(name, t, r, m, xm, ym, extra):
    from thermite_tpu_torch.ops.layout import pack_meta_host

    return [(f"{name} 9-col", t, r, m, xm, ym, extra),
            (f"{name} 4-col", t, r, pack_meta_host(m), xm, ym, extra)]


def phase_kernel(dev):
    """The packed kernel == plain on synthetic cases; -> (worst
    max_abs_err, (ms, plain_ms) at the main-path chunk shape)."""
    from thermite_tpu_torch.ops.layout import pack_meta_host
    from thermite_tpu_torch.ops.swg_stream import swg_stream

    cases = []
    for seed, bmax in ((0, 15), (1, 31)):
        cases += both_meta_forms(f"fuzz band<={bmax}",
                                 *fuzz_problems(seed, 4096, bmax), (256,))
    t, r, m, xm, ym = chunk_problems(7, 4096)
    cases.append(("certificate shapes (band 60->15)", t, r, m, xm, ym, (384,)))
    t, r, m, xm, ym = chunk_problems(8, 65536)
    cases.append(("main-path chunk shape (65536 rows, band<=15)", t, r,
                  pack_meta_host(m), xm, ym, (208,)))
    return run_cases(dev, cases, swg_stream)


def general_band_cases():
    """(name, problems, SMAX) of phases 2b and 2c: fuzz shapes per slot
    class, bands above XMAX (4 and 32 slots per lane), and the full-band
    chunk shape of the main path (65536 rows, band 60)."""
    from thermite_tpu_torch.ops.layout import pack_meta_host

    specs = [  # name, seed, n, band_min, band_max, XMAX, YMAX, SMAX
        ("fuzz band<=63", 10, 4096, 0, 63, 64, 96, 176),
        ("fuzz band<=127", 11, 4096, 0, 127, 128, 192, 336),
        ("fuzz band<=255 (windows 512)", 12, 2048, 128, 255, 512, 512, 1040),
        ("band>XMAX (XMAX 96)", 13, 4096, 97, 1023, 96, 160, 272),
        ("band>XMAX (XMAX 512, 1024 slots)", 14, 1024, 513, 1023, 512, 512, 1040),
    ]
    cases = []
    for name, seed, n, lo, hi, xm, ym, smax in specs:
        t, r, m, _, _ = fuzz_problems(seed, n, hi, xm, ym, band_min=lo)
        cases += both_meta_forms(name, t, r, m, xm, ym, (smax,))
    t, r, m, xm, ym = chunk_problems(9, 65536, wide=60, narrow=60)
    cases.append(("full-band chunk shape (65536 rows, band 60)", t, r,
                  pack_meta_host(m), xm, ym, (256,)))
    return cases


def phase_kernel_wide(dev, cases):
    """The general-band stream kernel == plain; -> (worst max_abs_err,
    (ms, plain_ms) at the full-band chunk shape)."""
    from thermite_tpu_torch.ops.swg_stream import swg_stream_wide

    launches = swg_stream_wide.launches
    out = run_cases(dev, cases, swg_stream_wide)
    check(swg_stream_wide.launches - launches >= len(cases),
          "the general-band kernel did not launch on every case")
    return out


def phase_kernel_forward(dev, cases):
    """The forward-scores kernel == plain; -> (worst max_abs_err,
    (ms, plain_ms) at the full-band chunk shape)."""
    from thermite_tpu_torch.ops.swg_forward import swg_forward, swg_forward_plain

    extra = both_meta_forms("fuzz band<=15", *fuzz_problems(15, 4096, 15), ())
    launches = swg_forward.launches
    out = run_cases(dev, extra + [c[:6] + ((),) for c in cases],
                    swg_forward, plain=swg_forward_plain, stream=False)
    check(swg_forward.launches - launches >= len(cases) + len(extra),
          "the forward kernel did not launch on every case")
    return out


def _bam_primary_flags(raw: bytes) -> np.ndarray:
    """FLAG of every primary record in a blob of BAM records."""
    flags, off = [], 0
    while off < len(raw):
        size = int.from_bytes(raw[off : off + 4], "little")
        flag = int.from_bytes(raw[off + 18 : off + 20], "little")
        if not flag & 0x900:
            flags.append(flag)
        off += 4 + size
    check(off == len(raw), "BAM record blob does not parse")
    return np.asarray(flags)


def reset_launches():
    from thermite_tpu_torch.ops.swg_forward import swg_forward
    from thermite_tpu_torch.ops.swg_stream import swg_stream, swg_stream_wide

    swg_stream.launches = swg_stream_wide.launches = swg_forward.launches = 0


def read_launches() -> dict:
    from thermite_tpu_torch.ops.swg_forward import swg_forward
    from thermite_tpu_torch.ops.swg_stream import swg_stream, swg_stream_wide

    return {"swg_stream": swg_stream.launches,
            "swg_stream_wide": swg_stream_wide.launches,
            "swg_forward": swg_forward.launches}


def timed_runs(aligner, recs, first_s):
    """Four more runs of the batch after one of ``first_s`` seconds;
    logs the five reads/s and returns their median."""
    import torch

    rates = [len(recs) / first_s]
    for _ in range(4):
        t = time.perf_counter()
        aligner.align_batch_emit(recs, True)
        torch.cuda.synchronize()
        rates.append(len(recs) / (time.perf_counter() - t))
    med = float(np.median(rates))
    log("  reads/s over 5 runs of the batch: "
        + " ".join(f"{r:.1f}" for r in rates) + f"; median {med:.1f}")
    return med


def phase_syn45(tmp):
    """Index syn45 in memory and run the main path once, counted."""
    import torch

    from thermite_tpu.align.driver import AlignOpts
    from thermite_tpu.index.build import Index
    from thermite_tpu.testing.synth import make_truth_reads, write_synth_genome
    from thermite_tpu_torch.align.batch import BatchAligner

    t0 = time.perf_counter()
    fasta, gtf = write_synth_genome(tmp, SYN_BP, seed=1234, basename="syn45")
    index = Index.create_from_files(fasta, gtf)
    t1 = time.perf_counter()
    opts = AlignOpts(min_seed_len=20, min_aln_score_percent=0.0,
                     min_aln_score=30, intron_mode=True)
    aligner = BatchAligner(index, opts, device="cuda")
    t2 = time.perf_counter()
    log(f"  syn45: {len(index.seq)} bp fwd+rc, {len(index.txome.txs)} "
        f"transcripts; FASTA+index {t1 - t0:.1f} s, aligner (seed table, "
        f"C++ engine) {t2 - t1:.1f} s")
    recs = [(n.encode(), s, b"I" * len(s))
            for n, s in make_truth_reads(index, N_READS, seed=3)]
    warm = [(n.encode(), s, b"I" * len(s))
            for n, s in make_truth_reads(index, 8192, seed=4)]
    t3 = time.perf_counter()
    aligner.align_batch_emit(warm, True)  # text upload, first launches
    torch.cuda.synchronize()
    log(f"  warm-up: 8192 reads in {time.perf_counter() - t3:.2f} s "
        f"(resident text {aligner._ref_text().numel() * 4 / 1e6:.1f} MB)")

    aligner.stats.reset()
    reset_launches()
    t4 = time.perf_counter()
    raw = aligner.align_batch_emit(recs, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t4
    launches = read_launches()
    stats = aligner.stats
    report = stats.report()
    flags = _bam_primary_flags(raw)
    mapped = float(np.mean((flags & 4) == 0)) if len(flags) else 0.0
    log(f"  main path: {N_READS} reads, {stats.chunks} chunks, "
        f"launches {launches}, {len(raw)} BAM bytes, "
        f"mapped {100 * mapped:.2f}%, cert patches {stats.cert_patches}, "
        f"wall {wall:.3f} s = {N_READS / wall:.1f} reads/s")
    log(report)
    check(len(flags) == N_READS, f"{len(flags)} primary records for {N_READS} reads")
    check(stats.chunks >= 1 and launches["swg_stream"] >= stats.chunks,
          f"{launches} kernel launches for {stats.chunks} chunks")
    check(mapped > 0.9, f"only {100 * mapped:.2f}% of reads mapped")
    timed_runs(aligner, recs, wall)
    _profile_run(aligner, recs)
    return index, opts, aligner, recs, warm, raw, launches["swg_stream"]


def phase_full_band(index, opts, recs, warm, raw_narrow):
    """The same reads at full band: the general-band kernel on band 60,
    the same BAM bytes as the narrowed run."""
    import torch

    from thermite_tpu_torch.align.batch import BatchAligner

    aligner = BatchAligner(index, opts, device="cuda")
    aligner.narrow_band = 0
    aligner.align_batch_emit(warm, True)
    torch.cuda.synchronize()
    aligner.stats.reset()
    reset_launches()
    t0 = time.perf_counter()
    raw = aligner.align_batch_emit(recs, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = aligner.stats
    log(f"  full band: {N_READS} reads, {stats.chunks} chunks, launches "
        f"{launches}, XMAX {aligner._XMAX} YMAX {aligner._YMAX} SMAX "
        f"{aligner._SMAX}, {len(raw)} BAM bytes, == narrowed run: "
        f"{raw == raw_narrow}, cert patches {stats.cert_patches}, "
        f"wall {wall:.3f} s = {N_READS / wall:.1f} reads/s")
    log(stats.report())
    check(raw == raw_narrow, "full-band BAM bytes differ from the narrowed run's")
    check(launches["swg_stream_wide"] >= stats.chunks >= 1,
          f"{launches} kernel launches for {stats.chunks} chunks")
    check(launches["swg_stream"] == 0, "the packed kernel ran at full band")
    timed_runs(aligner, recs, wall)
    return launches["swg_stream_wide"]


def phase_no_native(index, opts, aligner, recs):
    """The path without the C++ engine on the first N_NO_NATIVE reads:
    the same BAM bytes as the C++ engine's path."""
    import torch

    from thermite_tpu_torch.align.batch import BatchAligner

    sub = recs[:N_NO_NATIVE]
    want = aligner.align_batch_emit(sub, True)
    py = BatchAligner(index, opts, device="cuda", use_native=False)
    py.align_batch_emit(sub[:256], True)  # text upload
    torch.cuda.synchronize()
    py.stats.reset()
    reset_launches()
    t0 = time.perf_counter()
    got = py.align_batch_emit(sub, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = py.stats
    log(f"  no C++ engine: {len(sub)} reads, {stats.chunks} chunks, "
        f"{stats.problems} problems, {stats.winners} winners, launches "
        f"{launches}, {len(got)} BAM bytes, == C++ engine path: "
        f"{got == want}, wall {wall:.3f} s = {len(sub) / wall:.1f} reads/s")
    log(stats.report())
    check(got == want, "BAM bytes without the C++ engine differ")
    check(launches["swg_forward"] >= stats.chunks >= 1
          and launches["swg_stream_wide"] >= stats.chunks,
          f"{launches} kernel launches for {stats.chunks} chunks")
    return launches["swg_forward"]


def _profile_run(aligner, recs):
    """One more run under torch.profiler: the device's busy time (the
    union of its kernel and copy intervals) against the run's wall time
    (traced, so slower), and the device time by kernel or copy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            aligner.align_batch_emit(recs, True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.device_type == DeviceType.CUDA)
    except RuntimeError as e:
        log(f"  profiler unavailable ({e}); device busy share not measured")
        return
    busy_us, reach, by_name = 0, float("-inf"), {}
    for a, b, name in spans:
        busy_us += max(b - max(a, reach), 0)
        reach = max(reach, b)
        t, n = by_name.get(name, (0, 0))
        by_name[name] = (t + b - a, n + 1)
    if not busy_us:
        log("  profiler recorded no device time; device busy share not measured")
        return
    busy = busy_us / 1e6
    log(f"  profiled run: wall {wall:.3f} s, device busy {1e3 * busy:.3f} ms "
        f"({100 * busy / wall:.2f}% of wall, idle {100 - 100 * busy / wall:.2f}%)")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"    {name[:70]}: {t / 1e3:.3f} ms over {n} calls")


def phase_cpp_referee(aligner, recs):
    """One syn45 chunk: kernel == plain on its real rows (timed), and
    every certified row == the C++ full-band scalar SWG."""
    from thermite_tpu_torch.ops.layout import expand_stream_hdr
    from thermite_tpu_torch.ops.swg_stream import swg_stream

    reads = [r[1] for r in recs]
    aligner._pin_shapes(reads)
    st, _ = aligner._build_chunk(reads, 0)
    aligner._dispatch_forward(st)
    hdr = expand_stream_hdr(st.hdr.wait()[: len(st.fwd_idx)])
    dev_streams = st.fwd_streams[: len(st.fwd_idx)].cpu().numpy()
    n = len(st.meta_all)
    pw_host = aligner._SMAX_HOST // 16
    kern = np.zeros((n, 4 + pw_host), np.int32)
    kern[st.fwd_idx, :4] = hdr
    kern[st.fwd_idx, 4 : 4 + dev_streams.shape[1]] = dev_streams
    t0 = time.perf_counter()
    ref = np.zeros_like(kern)
    aligner.native.patch_rows(st.meta_all, st.fwd_idx, st.reads_host,
                              aligner._ref_text_host, ref)
    cpp_s = time.perf_counter() - t0
    rows = st.fwd_idx[kern[st.fwd_idx, 3] >= 0]
    differ = int((kern[rows] != ref[rows]).any(1).sum())
    log(f"  chunk: {n} problems, {len(st.fwd_idx)} on the card, "
        f"{len(rows)} certified, {len(st.fwd_idx) - len(rows)} left to the "
        f"full-band patch; certified rows != C++ full band: {differ} "
        f"(C++ referee {cpp_s:.1f} s)")
    check(differ == 0, f"{differ} certified rows differ from the C++ referee")

    # the same launch again, against the plain version, timed
    sub = aligner._narrow_meta(st.meta_all)[st.fwd_idx]
    meta = aligner._upload(aligner._pack_meta(
        aligner._pad_meta(sub, aligner._NFWD1)))
    words = aligner._ref_text()
    args = (words, words.shape[0], st.reads_dev, meta, aligner._XMAX,
            aligner._YMAX, aligner._SMAX)
    kernel = functools.partial(swg_stream, band_max=int(sub[:, 7].max(initial=1)))
    nbad, err, ms, plain_ms, _ = compare_kernel(args, reps=20, kernel=kernel)
    log(f"  kernel vs plain on this chunk ({len(sub)} rows padded to "
        f"{aligner._NFWD1}, XMAX {aligner._XMAX} YMAX {aligner._YMAX} "
        f"SMAX {aligner._SMAX}): {nbad} differ, max_abs_err {err}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
    check(nbad == 0, "kernel != plain on the syn45 chunk")
    aligner.native.free_chunk(st.native_ch)
    return err, ms, plain_ms


def phase_oracle(index, opts, aligner, recs):
    """SAM records of the first reads == the reference oracle's."""
    from thermite_tpu.align.driver import align_read
    from thermite_tpu.io.sam import aln_to_sam_record, unmapped_sam_record

    sub = recs[:N_ORACLE]
    got = aligner.align_batch_emit(sub, False)
    lines = []
    for name, seq, qual in sub:
        alns = align_read(index, seq, opts, aligner.seeder)
        if not alns:
            lines.append(unmapped_sam_record(name, seq, qual).to_line())
        for i, aln in enumerate(alns):
            lines.append(aln_to_sam_record(index, name, seq, qual, aln,
                                           len(alns), i + 1).to_line())
    want = "".join(line + "\n" for line in lines).encode()
    log(f"  {len(sub)} reads: {len(lines)} SAM records, port == oracle: "
        f"{got == want}")
    check(got == want, "SAM records differ from the oracle's")


def phase_cli(index, tmp, recs):
    """The user entry points: save the index, then the port's CLI aligns
    a FASTQ to SAM from the loaded artifact; == the in-memory emit."""
    from thermite_tpu.io.sam import build_sam_header
    from thermite_tpu.testing.synth import write_fastq
    from thermite_tpu_torch.cli import main as cli_main

    sub = recs[:2000]
    fq = os.path.join(tmp, "reads.fq")
    write_fastq([(n.decode(), s) for n, s, _ in sub], fq)
    art = os.path.join(tmp, "syn45.tai.npz")
    t0 = time.perf_counter()
    index.build_seed_table(stride=1)
    index.save(art)
    t1 = time.perf_counter()
    out = os.path.join(tmp, "out.sam")
    rc = cli_main(["align", art, fq, "-a", "-o", out, "-k", "20", "-s", "0",
                   "--intron-mode"])
    t2 = time.perf_counter()
    with open(out, "rb") as f:
        got = f.read()
    return got, t1 - t0, t2 - t1, rc, build_sam_header(index).encode()


def run(kernels_only: bool = False) -> dict:
    import torch

    t = time.perf_counter()
    log("phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log("  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from thermite_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_kernels()
    log(f"  kernels built in parallel in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log(f"  {name}: {os.path.relpath(path, ROOT)}")
        for line in _build.build_log.get(name, "").splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")):
                log(f"    {line.strip()}")
    t0 = time.perf_counter()
    _build.native_engine()
    log(f"  C++ host engine ready in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    log(f"phase 1 done in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2: packed stream kernel vs swg_stream_plain (bit-exact)")
    worst1, _ = phase_kernel(dev)
    log(f"phase 2 done in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2b: general-band stream kernel vs swg_stream_plain (bit-exact)")
    cases = general_band_cases()
    worst2, (ms2, plain_ms2) = phase_kernel_wide(dev, cases)
    log(f"phase 2b done in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2c: forward-scores kernel vs swg_forward_plain (bit-exact)")
    worst3, (ms3, plain_ms3) = phase_kernel_forward(dev, cases)
    log(f"phase 2c done in {time.perf_counter() - t:.1f} s")
    del cases

    launches = {"swg_stream": None, "swg_stream_wide": None, "swg_forward": None}
    err = ms = plain_ms = None
    if not kernels_only:
        os.makedirs(os.path.join(ROOT, "data", "out"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "data", "out")) as tmp:
            t = time.perf_counter()
            log("phase 3: syn45 main path (BatchAligner.align_batch_emit, BAM)")
            index, opts, aligner, recs, warm, raw, launches["swg_stream"] = \
                phase_syn45(tmp)
            log(f"phase 3 done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 3b: syn45 at full band (narrow_band 0)")
            launches["swg_stream_wide"] = phase_full_band(index, opts, recs,
                                                          warm, raw)
            log(f"phase 3b done in {time.perf_counter() - t:.1f} s")
            del warm, raw

            t = time.perf_counter()
            log(f"phase 3c: syn45 without the C++ engine on {N_NO_NATIVE} reads")
            launches["swg_forward"] = phase_no_native(index, opts, aligner, recs)
            log(f"phase 3c done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 4: C++ full-band referee on one syn45 chunk")
            err, ms, plain_ms = phase_cpp_referee(aligner, recs)
            log(f"phase 4 done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log(f"phase 5: oracle referee on the first {N_ORACLE} reads")
            phase_oracle(index, opts, aligner, recs)
            log(f"phase 5 done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 6: CLI (index save/load, align to SAM) on 2000 reads")
            got, save_s, align_s, rc, header = phase_cli(index, tmp, recs)
            want = header + aligner.align_batch_emit(recs[:2000], False)
            log(f"  index save {save_s:.1f} s, CLI align {align_s:.1f} s, "
                f"rc {rc}, CLI SAM == in-memory emit: {got == want}")
            check(rc == 0 and got == want,
                  "CLI SAM differs from the in-memory emit")
            log(f"phase 6 done in {time.perf_counter() - t:.1f} s")

    def record(name, source, replaces, worst, k_ms, p_ms):
        return {"name": name, "route": "cuda",
                "source": f"thermite_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms}

    return {"kernels": [
        record("swg_stream", "swg_stream.cu",
               "thermite_tpu/ops/swg_pallas_packed.py:88",
               max(worst1, err or 0), ms, plain_ms),
        record("swg_stream_wide", "swg_stream_wide.cu",
               "thermite_tpu/ops/swg_pallas.py:409", worst2, ms2, plain_ms2),
        record("swg_forward", "swg_forward.cu",
               "thermite_tpu/ops/swg_pallas.py:185", worst3, ms3, plain_ms3),
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    try:
        result = run(kernels_only="--kernels-only" in sys.argv[1:])
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:  # a phase that raised: report it and fail the run
        import traceback

        traceback.print_exc()
        return 1
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
