"""Pipeline observability: per-stage timers and throughput counters.

The reference has no in-code instrumentation (its only observability is
zsh REPORTTIME around make targets, reference data/Makefile:45-51);
the port keeps designed-in equivalents:
per-stage wall times, reads/s, and DP-cell throughput (GCUPS).
``BatchAligner`` feeds one ``PipelineStats`` across its lifetime;
``thermite align -v`` prints the report.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict


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
    stage_s: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    _t0: float = field(default_factory=time.time)

    @contextmanager
    def stage(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.stage_s[name] += time.time() - t

    @contextmanager
    def dsync(self, outer: str):
        """Time a device sync point (np.asarray of an async result)
        nested inside ``stage(outer)``.  The report subtracts it from
        the outer stage so host CPU time and device-wait + d2h-transfer
        time stop masquerading as one another (on a host with few cores the
        sync absorbs the kernel wall and the transfer, which would
        otherwise read as host arbitration time)."""
        t = time.time()
        try:
            yield
        finally:
            self.stage_s[outer + "/dsync"] += time.time() - t

    def wall_s(self) -> float:
        return time.time() - self._t0

    def reset(self) -> None:
        """Zero all counters/timers and restart the clock.  Call after a
        warmup batch so the report reflects steady-state only — kernel
        compiles otherwise sync into whichever stage first touches the
        device output and masquerade as run time."""
        self.reads = self.chunks = self.problems = self.tasks = 0
        self.winners = self.dp_cells = self.stream_fallbacks = 0
        self.dp_cells_ref = self.cert_patches = 0
        self.stage_s.clear()
        self._t0 = time.time()

    def report(self) -> str:
        wall = max(self.wall_s(), 1e-9)
        lines = [
            "pipeline stats:",
            f"  reads\t{self.reads}",
            f"  chunks\t{self.chunks}",
            f"  extension problems\t{self.problems}",
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
        for name, s in sorted(self.stage_s.items()):
            if name.endswith("/dsync"):
                lines.append(
                    f"  stage {name[:-6]} device wait+d2h\t{s:.3f} s"
                    f" ({100 * s / wall:.0f}%)"
                )
                continue
            sub = self.stage_s.get(name + "/dsync", 0.0)
            host = s - sub
            tag = " host" if sub else ""
            lines.append(
                f"  stage {name}{tag}\t{host:.3f} s ({100 * host / wall:.0f}%)"
            )
        return "\n".join(lines)
