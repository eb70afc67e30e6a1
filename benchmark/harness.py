"""One run of one cell: set-up, the measured window, the traced
sub-window, the check, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in the file that entry names, its traffic mix in
``traffic/<mix>.json`` (whose ``generator`` names a module of ``gen/``),
and each metric's reader in ``metrics/<metric>.py``.  Adding a cell, a
configuration, a mix or a metric adds files and entries; this module
does not change.

The window drives the CLI's main path (``align/run.py::_align_reads``)
one batch at a time: ``BatchAligner.align_batch_emit(records, True)``,
then ``BamWriter.write_raw`` into ``bamsink.BlockSink``.  Each batch's
records are made from (seed, batch) before the batch; the window's clock
sums the time inside those two calls, and the window ends at the first
batch boundary past ``seconds``.

Between the two calls, outside the window's clock, ``check.Retention``
decides whether the sink keeps the batch's blocks and which kept batch
they evict.  The run holds (batch, lo, hi) of each kept batch and no
reads: the check's reads are made again from (seed, batch) after the
peak memory has been read and the program's state freed, so the
harness's share of ``host_peak_gib`` is the blocks of
``check.RETAIN_BATCHES`` batches at most, however fast the program runs.

Set-up runs from the process's start through one warm-up batch, less
``ensure_caches``: the genome and the artifact that a checkout's first
run builds once, as a user indexes once and aligns many times, are timed
apart (``cache_build_s``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

TRACE_BATCHES = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "thermite_tpu")


class CellError(RuntimeError):
    """A run that cannot produce a result (no card, unknown name, JAX
    loaded): the entry point prints it and exits non-zero."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def bench_dir(root: str) -> str:
    """The benchmark's folder in the checkout at ``root``."""
    return os.path.join(root, "benchmark")


def cache_dir(root: str) -> str:
    """What a checkout's first run builds (genomes, artifacts), reused by
    the runs after it."""
    return os.path.join(bench_dir(root), ".cache")


def find_cell(root: str, workload: str):
    """-> (spec, cell, configuration dict, traffic dict) for ``workload``."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(bench_dir(root), "traffic",
                                     cell["traffic"] + ".json"))
    return spec, cell, cfg, traffic


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: str, name: str) -> Callable:
    return load_module(os.path.join(bench_dir(root), "metrics", name + ".py"),
                       "benchmark_metric_" + name.replace(".", "_")).read


def generator(root: str, name: str):
    return load_module(os.path.join(bench_dir(root), "gen", name + ".py"),
                       "benchmark_gen_" + name)


def cell_metrics(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    with ``trace`` 0, the per-layer ones with 1."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``thermite_tpu_torch`` is neither)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def ensure_caches(root: str, cfg: dict) -> dict:
    """What the first run of a checkout builds and the runs after it
    reuse: the genome's FASTA, GTF and sidecar and, for an artifact
    index, the artifact (``thermite index`` in a process of its own, as a
    user runs it once before aligning many times).  -> the genome's
    sidecar, with ``artifact`` set where there is one."""
    genome = dict(generator(root, "synth_genome").ensure(cache_dir(root), cfg))
    if cfg["index"] == "artifact":
        art = os.path.join(cache_dir(root), f"{cfg['name']}.index.npz")
        if not os.path.exists(art):
            part = art[: -len(".npz")] + ".part.npz"
            subprocess.run(
                [sys.executable, "-m", "thermite_tpu_torch.cli", "index",
                 genome["fasta"], genome["gtf"], "-o", part,
                 "--seed-stride", str(cfg["seed_stride"])],
                check=True, cwd=root,
                env=dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path)))
            os.replace(part, art)
        genome["artifact"] = art
    return genome


def port_index(cfg: dict, genome: dict):
    """The program's index as a user of this deployment has it: the
    artifact loaded memory-mapped, or the in-memory build with its seed
    table."""
    from thermite_tpu_torch.index.build import Index

    if cfg["index"] == "artifact":
        idx = Index.load(genome["artifact"], mmap=True)
        idx.warm_mmap()
        return idx
    if cfg["index"] == "memory":
        idx = Index.create_from_files(genome["fasta"], genome["gtf"])
        idx.build_seed_table(stride=cfg["seed_stride"])
        return idx
    raise CellError(f"unknown index form {cfg['index']!r}")


def cpu_s() -> float:
    """The process's CPU seconds so far, all its threads: read around the
    window, so that a slower host (the same work in more CPU seconds)
    can be told from more work."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def rss_gib() -> float:
    """The process's peak resident memory so far (``ru_maxrss``), GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def port_opts(cfg: dict):
    from thermite_tpu_torch.align.driver import AlignOpts

    o = cfg["opts"]
    return AlignOpts(min_seed_len=o["min_seed_len"],
                     min_aln_score_percent=o["min_aln_score_percent"],
                     min_aln_score=o["min_aln_score"],
                     multimap_score_range=o["multimap_score_range"],
                     intron_mode=o["intron_mode"])


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             run_batch: Optional[Callable] = None) -> Dict[str, object]:
    """One run; -> the result line's dict.  ``device`` "cpu" and
    ``run_batch`` (called as ``run_batch(aligner, records)`` in place of
    ``align_batch_emit``) are for the tests: the first runs the plain
    PyTorch path without a card, the second breaks the timed path."""
    import torch

    from . import check
    from .bamsink import BlockSink
    from .trace import reduce_trace, spans_and_launches

    spec, cell, cfg, traffic = find_cell(root, workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        raise CellError(
            f"{workload} needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count()={torch.cuda.device_count()}")
    # one-off builds of a checkout's first run, timed apart from set-up
    t_cache = time.perf_counter()
    genome = ensure_caches(root, cfg)
    cache_build_s = time.perf_counter() - t_cache
    from thermite_tpu_torch.align.batch import BatchAligner
    from thermite_tpu_torch.io.bam import BamWriter

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the card's context, timed as set-up
    phases = {"import_probe": time.time() - t_start - cache_build_s}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        phases[name + "_rss_gib"] = rss_gib()
        mark = now

    gen = generator(root, traffic["generator"])
    spans: Dict[str, float] = {}
    index = port_index(cfg, genome)
    phase("index")
    spans["index_ready"] = phases["index"]
    aligner = BatchAligner(index, port_opts(cfg), device=dev)
    align = run_batch or (lambda a, recs: a.align_batch_emit(recs, True))
    phase("aligner")
    warm = gen.make_batch(genome, traffic, seed, 1, 0)
    BamWriter(BlockSink(), index).write_raw(align(aligner, warm))
    sync()
    phase("warmup")
    spans.update({k: v for k, v in aligner.stats.stage_s.items()
                  if k.startswith("text ")})
    aligner.stats.reset()
    setup_s = time.time() - t_start - cache_build_s

    sink = BlockSink()
    writer = BamWriter(sink, index)
    head = len(writer.bgzf.buf) if sink.blocks == 0 else None
    if head is None:
        raise CellError("the BAM header filled a whole BGZF block")
    sink.want(0, head)
    uoff = head
    retention = check.Retention(seed)
    kept = {}  # batch -> (lo, hi): its records' span of the stream
    window_s = bam_s = 0.0
    reads = batch = 0
    batch_s: List[float] = []  # each batch's seconds on the window's clock

    def one_batch(recs, stamp=None):
        nonlocal uoff, window_s, bam_s, reads, batch
        a = time.perf_counter()
        raw = align(aligner, recs)
        b = time.perf_counter()
        keep, evicted = retention.offer(batch)
        if evicted is not None:
            sink.unwant(*kept.pop(evicted))
        if keep:
            kept[batch] = (uoff, uoff + len(raw))
            sink.want(*kept[batch])
        c = time.perf_counter()
        if stamp is None:
            writer.write_raw(raw)
        else:
            with stamp("bam_write"):
                writer.write_raw(raw)
        d = time.perf_counter()
        uoff += len(raw)
        window_s += (b - a) + (d - c)
        batch_s.append((b - a) + (d - c))
        bam_s += d - c
        reads += len(recs)
        batch += 1

    cpu0, wall0 = cpu_s(), time.perf_counter()
    while window_s < seconds:
        one_batch(gen.make_batch(genome, traffic, seed, 0, batch))
    wall, cpu = time.perf_counter() - wall0, cpu_s() - cpu0
    host_peak = rss_gib() * 2**30
    kept_at_peak = {"kept_batches": len(kept),
                    "kept_block_bytes": sink.kept_bytes()}
    st = aligner.stats
    run = {
        "reads": reads, "window_s": window_s, "batches": batch,
        "setup_s": setup_s, "host_peak_bytes": host_peak,
        "bam_write_s": bam_s, "stages": dict(st.stage_s),
        "counters": {"reads": st.reads, "chunks": st.chunks,
                     "problems": st.problems,
                     "cert_patches": st.cert_patches,
                     "stream_fallbacks": st.stream_fallbacks},
        "setup_spans": spans, "trace": None, "launches": None,
    }
    attempted = reads

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        batches = [gen.make_batch(genome, traffic, seed, 0, batch + i)
                   for i in range(TRACE_BATCHES)]
        launches: List[dict] = []
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with spans_and_launches(aligner, launches), \
                profile(activities=acts) as prof:
            a = time.perf_counter()
            for recs in batches:
                one_batch(recs, stamp=record_function)
            sync()
            traced_s = time.perf_counter() - a
        attempted += sum(len(r) for r in batches)
        for l in launches:
            l["meta"] = l["meta"].cpu().numpy()
        run["trace"] = reduce_trace(prof, traced_s)
        run["launches"] = launches
        del prof

    writer.finish()
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    del aligner, index, writer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_remake = time.perf_counter()
    checked = [(b, lo, hi, gen.make_batch(genome, traffic, seed, 0, b))
               for b, (lo, hi) in sorted(kept.items())]
    remake_s = time.perf_counter() - t_remake
    verdict = check.check_run(sink, head, checked, seed, genome, cfg)
    bad = verdict["mismatched_reads"]
    correct = bool(verdict["checked_reads"] > 0
                   and bad <= check.LIMIT_MISMATCHED)

    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        v = metric_reader(root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise CellError("modules of JAX or the JAX package are loaded: "
                        + ", ".join(found))
    out = {
        "correct": correct, "attempted": attempted, "failed": bad,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type),
            "count": 1, "memory_peak_bytes": int(mem_peak),
        },
    }
    if trace:
        t = run["trace"]
        out["device"]["busy_s"] = t["busy_s"]
        out["device"]["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["cache_build_s"] = cache_build_s
    out["check"] = {"mismatched_reads": {"value": bad,
                                         "limit": check.LIMIT_MISMATCHED}}
    info = {"batches": batch, "window_s": window_s, "sink_bytes": sink.bytes,
            "window_wall_s": wall, "window_cpu_s": cpu,
            "batch_s": [round(x, 4) for x in batch_s],
            "setup": phases, **kept_at_peak, "remake_s": remake_s,
            "checked_reads": verdict["checked_reads"],
            **{k: v for k, v in verdict.items() if k.endswith("_s")}}
    print("run: " + json.dumps(info), file=sys.stderr)
    return out
