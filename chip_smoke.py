#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (thermite_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed with its own timing; any failure exits non-zero
before the result lines are printed:

1. require CUDA; print the card's name and power limit; build the CUDA
   kernel (nvcc, sm_90a) and the C++ host engine (g++).
2. swg_stream kernel == swg_stream_plain (bit-exact, tolerance 0) on the
   same CUDA inputs: fuzz shapes for both band classes and meta forms,
   the narrow-band certificate shapes, and one full main-path chunk
   shape (65536 rows, XMAX 96, YMAX 128, band <= 15, SMAX 208), with
   both times.
3. syn45 in memory: a 45 Mbp synthetic spliced chromosome, indexed, and
   49152 truth reads through BatchAligner(device="cuda")
   .align_batch_emit(fmt_bam=True); asserts the kernel ran once per
   chunk or more and that more than 90% of reads mapped.
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


def fuzz_problems(seed, n, band_max):
    """The reference's packed-kernel fuzz shapes (XMAX 64, YMAX 96):
    random windows in both directions, some running into the padding."""
    from thermite_tpu_torch.ops.layout import meta_row

    rng = np.random.default_rng(seed)
    RPAD, XMAX, YMAX = 64, 64, 96
    text, reads, _ = _text_reads(rng, 5000, 32, RPAD, RPAD)
    rows = []
    for _ in range(n):
        band = int(rng.integers(0, band_max + 1))
        xd = int(rng.integers(1, 40))
        q = int(rng.integers(0, RPAD - 1))
        xdir = 1 if rng.random() < 0.5 else -1
        xlen = int(rng.integers(1, XMAX + 1))
        xlen = min(xlen, RPAD - q) if xdir == 1 else min(xlen, q + 1)
        p = int(rng.integers(0, len(text)))
        ydir = 1 if rng.random() < 0.5 else -1
        ylen = int(rng.integers(1, YMAX + 1))
        if rng.random() < 0.8:
            ylen = max(min(ylen, len(text) - p if ydir == 1 else p + 1), 1)
        ri = int(rng.integers(0, len(reads)))
        rows.append(meta_row(p, ydir, ylen, ri * RPAD + q, xdir, xlen, band, xd))
    return text, reads, np.asarray(rows, np.int32), XMAX, YMAX


def chunk_problems(seed, n, wide=60, narrow=15):
    """Main-path chunk shape: 90 bp flanks built at band `wide` (some
    reads carry a 25-base deletion) and narrowed to `narrow`, as
    BatchAligner._narrow_meta submits them."""
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
    return text, reads, meta, 96, 128


def _to_dev(text, reads, meta, dev):
    import torch

    from thermite_tpu_torch.ops.layout import pack_reads_nib_host, pack_text_nib_host

    words = torch.from_numpy(pack_text_nib_host(text)).to(dev)
    rnib = torch.from_numpy(pack_reads_nib_host(reads.reshape(-1))).to(dev)
    return words, rnib, torch.from_numpy(np.ascontiguousarray(meta)).to(dev)


def compare_kernel(args, reps=0):
    """The kernel and its plain version on the same CUDA inputs ->
    (rows that differ, max_abs_err, kernel ms or None, plain ms, nsteps)."""
    import torch

    from thermite_tpu_torch.ops.swg_stream import swg_stream, swg_stream_plain

    hk, sk = swg_stream(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp, sp = swg_stream_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(
        int((hk.to(torch.int64) - hp.to(torch.int64)).abs().max()),
        int((sk.to(torch.int64) - sp.to(torch.int64)).abs().max()),
    )
    nbad = int(((hk != hp).any(1) | (sk != sp).any(1)).sum())
    ms = None
    if reps:
        start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(reps):
            swg_stream(*args)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / reps
    return nbad, err, ms, plain_ms, hk.view(torch.int16)[:, 3].cpu().numpy()


def phase_kernel(dev):
    """Kernel == plain on synthetic cases; -> worst max_abs_err."""
    from thermite_tpu_torch.ops.layout import pack_meta_host

    cases = []
    for seed, bmax in ((0, 15), (1, 31)):
        t, r, m, xm, ym = fuzz_problems(seed, 4096, bmax)
        cases.append((f"fuzz band<={bmax} 9-col", t, r, m, xm, ym, 256))
        cases.append((f"fuzz band<={bmax} 4-col", t, r, pack_meta_host(m), xm, ym, 256))
    t, r, m, xm, ym = chunk_problems(7, 4096)
    cases.append(("certificate shapes (band 60->15)", t, r, m, xm, ym, 384))
    t, r, m, xm, ym = chunk_problems(8, 65536)
    cases.append(("main-path chunk shape (65536 rows, band<=15)", t, r,
                  pack_meta_host(m), xm, ym, 208))
    worst = 0
    for name, t, r, m, xm, ym, smax in cases:
        words, rnib, mt = _to_dev(t, r, m, dev)
        nbad, err, ms, plain_ms, ns = compare_kernel(
            (words, words.shape[0], rnib, mt, xm, ym, smax),
            reps=20 if len(m) == 65536 else 0,
        )
        timing = f", kernel {ms:.4f} ms, plain {plain_ms:.1f} ms" if ms else ""
        log(f"  {name}: XMAX {xm} YMAX {ym} SMAX {smax}, {len(ns)} rows, "
            f"{nbad} differ, max_abs_err {err}, certified {(ns >= 0).sum()}, "
            f"cert failures {(ns <= -2).sum()}, bad walks {(ns == -1).sum()}"
            f"{timing}")
        check(nbad == 0, f"kernel != plain on {name}")
        if name.startswith("certificate"):
            check((ns <= -2).any(), "certificate shapes produced no -2-c rows")
        worst = max(worst, err)
    return worst


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


def phase_syn45(tmp):
    """Index syn45 in memory and run the main path once, counted."""
    import torch

    from thermite_tpu.align.driver import AlignOpts
    from thermite_tpu.index.build import Index
    from thermite_tpu.testing.synth import make_truth_reads, write_synth_genome
    from thermite_tpu_torch.align.batch import BatchAligner
    from thermite_tpu_torch.ops.swg_stream import swg_stream

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
    swg_stream.launches = 0
    t4 = time.perf_counter()
    raw = aligner.align_batch_emit(recs, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t4
    launches = swg_stream.launches
    stats = aligner.stats
    report = stats.report()
    flags = _bam_primary_flags(raw)
    mapped = float(np.mean((flags & 4) == 0)) if len(flags) else 0.0
    log(f"  main path: {N_READS} reads, {stats.chunks} chunks, "
        f"swg_stream launches {launches}, {len(raw)} BAM bytes, "
        f"mapped {100 * mapped:.2f}%, cert patches {stats.cert_patches}, "
        f"wall {wall:.3f} s = {N_READS / wall:.1f} reads/s")
    log(report)
    check(len(flags) == N_READS, f"{len(flags)} primary records for {N_READS} reads")
    check(stats.chunks >= 1 and launches >= stats.chunks,
          f"{launches} kernel launches for {stats.chunks} chunks")
    check(mapped > 0.9, f"only {100 * mapped:.2f}% of reads mapped")

    rates = [N_READS / wall]
    for _ in range(4):
        t5 = time.perf_counter()
        aligner.align_batch_emit(recs, True)
        torch.cuda.synchronize()
        rates.append(N_READS / (time.perf_counter() - t5))
    log("  reads/s over 5 runs of the batch: "
        + " ".join(f"{r:.1f}" for r in rates)
        + f"; median {float(np.median(rates)):.1f}")
    _profile_run(aligner, recs)
    return index, opts, aligner, recs, launches


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
    nbad, err, ms, plain_ms, _ = compare_kernel(args, reps=20)
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


def run() -> dict:
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
    path = _build.build_kernels()
    log(f"  kernel: {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    {line.strip()}")
    t0 = time.perf_counter()
    _build.native_engine()
    log(f"  C++ host engine ready in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    log(f"phase 1 done in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2: swg_stream kernel vs swg_stream_plain (bit-exact)")
    worst = phase_kernel(dev)
    log(f"phase 2 done in {time.perf_counter() - t:.1f} s")

    os.makedirs(os.path.join(ROOT, "data", "out"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "data", "out")) as tmp:
        t = time.perf_counter()
        log("phase 3: syn45 main path (BatchAligner.align_batch_emit, BAM)")
        index, opts, aligner, recs, launches = phase_syn45(tmp)
        log(f"phase 3 done in {time.perf_counter() - t:.1f} s")

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
        log(f"  index save {save_s:.1f} s, CLI align {align_s:.1f} s, rc {rc}, "
            f"CLI SAM == in-memory emit: {got == want}")
        check(rc == 0 and got == want, "CLI SAM differs from the in-memory emit")
        log(f"phase 6 done in {time.perf_counter() - t:.1f} s")

    return {
        "kernels": [{
            "name": "swg_stream",
            "route": "cuda",
            "source": "thermite_tpu_torch/csrc/swg_stream.cu",
            "replaces": "thermite_tpu/ops/swg_pallas_packed.py:88",
            "launches": launches,
            "max_abs_err": max(worst, err),
            "ms": ms,
            "plain_ms": plain_ms,
        }]
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    try:
        result = run()
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
