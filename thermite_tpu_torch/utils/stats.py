"""Pipeline observability: the program's span recorder and its counters.

The reference has no in-code instrumentation (its only observability is
zsh REPORTTIME around make targets, reference data/Makefile:45-51);
the port keeps designed-in equivalents:
per-span wall times, reads/s, and DP-cell throughput (GCUPS).
``BatchAligner`` feeds one ``PipelineStats`` across its lifetime;
``thermite align -v`` prints the report.

Spans nest: ``stage("seed")`` opened inside ``stage("build")`` records
under ``build/seed``; a top-level span's key is its bare name, and the
process's CPU seconds over it (every thread's, so the C++ pools count)
add to ``<name>/cpu``.  ``dsync(outer)`` records the device wait inside
``outer`` under ``<outer>/dsync``.  ``dsync`` and ``cpu`` are therefore
no span's name.  ``timed(name, seconds)`` records under the open span
seconds that the C++ engine timed itself (the exonic lifts:
``arbitrate/lift``, ``finalize/lift``).  While a ``torch.profiler``
records, each span is also a span of its trace, named by its path, with
the number of the chunk it belongs to (``chunk``) as its argument (an
engine-timed span is a mark at the end of its call, its microseconds the
argument ``us``); otherwise a span makes no torch call.  The recorder is
the pipeline thread's: spans opened on other threads would interleave
its path.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List

RESERVED = ("dsync", "cpu")  # leaf keys the recorder writes itself


def _profiler_on() -> bool:
    """Whether a torch profiler records now: torch's own Python flag,
    read without a call (torch not imported: none records)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _profiler_span(path: str, **args: int):
    """The profiler's span ``path`` with ``args`` (the chunk's number, ...)
    as its arguments (in a Chrome trace when the profiler records shapes,
    as ``utils/profile.py::profiled`` does)."""
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(path, (), args)


@dataclass
class PipelineStats:
    reads: int = 0
    chunks: int = 0
    problems: int = 0
    tasks: int = 0
    winners: int = 0
    dp_cells: int = 0  # padded batch cells submitted to the DP kernels
    dp_cells_ref: int = 0  # cells a full-band (reference-equivalent)
    #                        DP would compute for the same problems —
    #                        the fair GCUPS numerator when the adaptive
    #                        narrow-band pass shrinks dp_cells
    cert_patches: int = 0  # narrow-band certificate failures patched
    #                        by the host C++ oracle (exact; a high rate
    #                        means the narrow band is too tight for the
    #                        workload — see THERMITE_NARROW_BAND)
    stream_fallbacks: int = 0  # device-flagged unterminated walks
    #                           (host recompute; a mass fallback is a
    #                           silent performance cliff — see MAXIT in
    #                           the reference's stream kernels)
    # paired emit: chunks emitted by the C++ engine, pairs spliced in
    # from the Python writers, chunks serialized in Python
    emit_cpp_chunks: int = 0
    spliced_pairs: int = 0
    emit_py_chunks: int = 0
    # the BAM writer's BGZF blocks, and those of them compressed on its
    # thread pool (a write of two or more full blocks)
    bgzf_blocks: int = 0
    bgzf_pooled_blocks: int = 0
    # the transcriptome path: extension problems in transcript windows;
    # reads whose primary record is exonic, whose primary record skips
    # an intron (an N op), and reads with only an unmapped record
    # (single-end batches: a paired batch's mate rescue rewrites records
    # after the engine, so it counts none of the three)
    tx_problems: int = 0
    exonic_reads: int = 0
    spliced_reads: int = 0
    unmapped_reads: int = 0
    stage_s: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    chunk: int = -1  # the chunk the spans opened now belong to
    _open: List[str] = field(default_factory=list, repr=False)  # open spans
    _t0: float = field(default_factory=time.perf_counter)

    @contextmanager
    def stage(self, name: str):
        """Time the block as the span ``name``: under ``<outer>/name``
        inside the open span ``outer``, else under ``name`` with the
        process's CPU seconds under ``name/cpu``."""
        if name in RESERVED or "/" in name:
            raise ValueError(f"{name!r} cannot name a span")
        opened = self._open
        top = not opened
        path = name if top else f"{opened[-1]}/{name}"
        opened.append(path)
        rec = _profiler_span(path, chunk=self.chunk) if _profiler_on() \
            else None
        if rec is not None:
            rec.__enter__()
        cpu = time.process_time() if top else 0.0
        t = time.perf_counter()
        try:
            yield
        finally:
            self.stage_s[path] += time.perf_counter() - t
            if top:
                self.stage_s[path + "/cpu"] += time.process_time() - cpu
            opened.pop()
            if rec is not None:
                rec.__exit__(None, None, None)

    def timed(self, name: str, seconds: float) -> None:
        """Add ``seconds`` timed elsewhere (inside a C++ call) to the
        span ``name`` under the open span."""
        if name in RESERVED or "/" in name or not self._open:
            raise ValueError(f"{name!r} cannot name an inner span here")
        path = f"{self._open[-1]}/{name}"
        self.stage_s[path] += seconds
        if _profiler_on():
            with _profiler_span(path, chunk=self.chunk,
                                us=round(seconds * 1e6)):
                pass

    @contextmanager
    def dsync(self, outer: str):
        """Time a device sync point (np.asarray of an async result)
        nested inside ``stage(outer)``.  The report subtracts it from
        the outer stage so host CPU time and device-wait + d2h-transfer
        time stop masquerading as one another (on a host with few cores the
        sync absorbs the kernel wall and the transfer, which would
        otherwise read as host arbitration time)."""
        key = outer + "/dsync"
        rec = _profiler_span(key, chunk=self.chunk) if _profiler_on() \
            else None
        if rec is not None:
            rec.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.stage_s[key] += time.perf_counter() - t
            if rec is not None:
                rec.__exit__(None, None, None)

    def wall_s(self) -> float:
        return time.perf_counter() - self._t0

    def reset(self) -> None:
        """Zero all counters/timers and restart the clock.  Call after a
        warmup batch so the report reflects steady-state only — kernel
        compiles otherwise sync into whichever stage first touches the
        device output and masquerade as run time."""
        self.reads = self.chunks = self.problems = self.tasks = 0
        self.winners = self.dp_cells = self.stream_fallbacks = 0
        self.dp_cells_ref = self.cert_patches = 0
        self.emit_cpp_chunks = self.spliced_pairs = self.emit_py_chunks = 0
        self.bgzf_blocks = self.bgzf_pooled_blocks = 0
        self.tx_problems = self.exonic_reads = 0
        self.spliced_reads = self.unmapped_reads = 0
        self.stage_s.clear()
        self._t0 = time.perf_counter()

    def spans(self) -> List[str]:
        """Every recorded span's path, each after its parent (the
        ``/cpu`` and ``/dsync`` keys are not spans)."""
        return sorted((k for k in self.stage_s
                       if k.rpartition("/")[2] not in RESERVED),
                      key=lambda k: k.split("/"))

    def self_s(self, path: str) -> float:
        """The span's seconds outside its child spans and its device
        wait (never below 0: the children ran inside it, on the same
        clock, so only rounding could take it there)."""
        st = self.stage_s
        inner = sum(v for k, v in st.items() if k.rpartition("/")[0] == path
                    and k.rpartition("/")[2] != "cpu")
        return max(st.get(path, 0.0) - inner, 0.0)

    def split(self) -> Dict[str, float]:
        """The top-level spans' seconds: each one's host time (its wall
        less its device wait) under its name, or ``<name> host`` where
        it waited for the card, and that wait under ``<name> device
        wait+d2h``."""
        out = {}
        for name in self.spans():
            if "/" in name:
                continue
            wait = self.stage_s.get(name + "/dsync")
            if wait is None:
                out[name] = self.stage_s[name]
            else:
                out[f"{name} host"] = self.stage_s[name] - wait
                out[f"{name} device wait+d2h"] = wait
        return out

    def report(self) -> str:
        wall = max(self.wall_s(), 1e-9)
        lines = [
            "pipeline stats:",
            f"  reads\t{self.reads}",
            f"  chunks\t{self.chunks}",
            f"  extension problems\t{self.problems}",
            f"  of them in transcript windows\t{self.tx_problems}",
            f"  tasks (seed x target)\t{self.tasks}",
            f"  traceback winners\t{self.winners}",
            f"  wall time\t{wall:.3f} s",
            f"  throughput\t{self.reads / wall:.1f} reads/s",
            f"  DP cells submitted\t{self.dp_cells}",
            f"  effective DP throughput\t{self.dp_cells / wall / 1e9:.2f} GCUPS",
        ]
        if self.dp_cells_ref:
            lines.append(
                f"  full-band-equivalent cells\t{self.dp_cells_ref}"
                f" ({self.dp_cells_ref / wall / 1e9:.2f} GCUPS-equiv)"
            )
        if self.cert_patches:
            lines.append(f"  narrow-band cert patches\t{self.cert_patches}")
        if self.stream_fallbacks:
            lines.append(
                f"  stream-walk host fallbacks\t{self.stream_fallbacks}"
            )
        if self.exonic_reads or self.spliced_reads or self.unmapped_reads:
            lines.append(
                f"  reads: primary exonic / spliced, unmapped"
                f"\t{self.exonic_reads} / {self.spliced_reads},"
                f" {self.unmapped_reads}")
        if self.bgzf_blocks:
            lines.append(f"  BGZF blocks\t{self.bgzf_blocks}"
                         f" ({self.bgzf_pooled_blocks} on the pool)")
        spans = self.spans()
        if spans:
            lines.append("  spans: wall (share of the wall time), self (less"
                         " the spans inside and the device wait);"
                         " CPU/wall of the top-level ones")
        for path in spans:
            s = self.stage_s[path]
            pad = "  " * (path.count("/") + 2)
            line = (f"{pad}{path.rpartition('/')[2]}\t{s:.3f} s"
                    f" ({100 * s / wall:.0f}%)\tself {self.self_s(path):.3f} s")
            if "/" not in path:
                cpu = self.stage_s.get(path + "/cpu", 0.0)
                line += f"\tCPU/wall {cpu / max(s, 1e-9):.2f}"
            lines.append(line)
            wait = self.stage_s.get(path + "/dsync")
            if wait is not None:
                lines.append(f"{pad}  device wait+d2h\t{wait:.3f} s"
                             f" ({100 * wait / wall:.0f}%)")
        return "\n".join(lines)
