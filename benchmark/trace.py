"""The traced sub-window of a ``--trace 1`` run: ``torch.profiler`` over a
few batches, spans around the program's stages, and a record of every
stream-kernel launch's rows; then the reduction from the trace to what
the per-layer metrics read.

Spans: the benchmark wraps the aligner's ``stats.stage`` and
``stats.dsync`` (the program's own stage boundaries) and its own BAM
write in ``torch.profiler.record_function``, so an idle gap of the card
can be named by what the host was doing.  Launches: the benchmark wraps
the name ``swg_stream`` where ``parallel/mesh.py`` calls it, and keeps
each launch's meta tensor and shapes (decoded after the sub-window, so
the wrapper adds no synchronisation).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Tuple

STREAM_KERNEL = "stream_kernel"  # the stream kernels' __global__ name


@contextmanager
def spans_and_launches(aligner, launches: List[dict]):
    """Within the block, the aligner's stages are profiler spans and
    every ``swg_stream`` launch appends {meta, XMAX, YMAX, SMAX} to
    ``launches``."""
    from torch.profiler import record_function

    from thermite_tpu_torch.parallel import mesh

    stats = aligner.stats
    stage, dsync, launch = stats.stage, stats.dsync, mesh.swg_stream

    def wrap(inner, prefix):
        @contextmanager
        def span(name):
            with record_function(prefix + name), inner(name):
                yield
        return span

    def counted(text, text_lw, reads, meta, XMAX, YMAX, SMAX, **kw):
        launches.append({"meta": meta, "XMAX": XMAX, "YMAX": YMAX,
                         "SMAX": SMAX})
        return launch(text, text_lw, reads, meta, XMAX, YMAX, SMAX, **kw)

    stats.stage, stats.dsync = wrap(stage, ""), wrap(dsync, "wait:")
    mesh.swg_stream = counted
    try:
        yield
    finally:
        del stats.stage, stats.dsync  # back to the class's methods
        mesh.swg_stream = launch


def reduce_trace(prof, window_s: float) -> Dict[str, object]:
    """-> busy_s (union of the card's kernel and copy intervals), the
    stream kernels' seconds, the ten longest device operations by name,
    and the idle gaps summed by the innermost host span at each gap's
    middle (``host`` outside every span)."""
    from torch.autograd import DeviceType

    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end, e.name)
        ours = e.name in _SPAN_NAMES or e.name.startswith("wait:")
        if e.device_type == DeviceType.CUDA:
            # a span is also recorded on the card's timeline (kineto's
            # user annotation over the kernels it launched): not device work
            if not (ours or getattr(e, "is_user_annotation", False)):
                dev.append(iv)
        elif ours:
            host.append(iv)
    dev.sort()
    by_name: Dict[str, float] = {}
    merged: List[List[float]] = []
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps: Dict[str, float] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        label, start = "host", None
        for s, e, name in host:
            if s <= mid <= e and (start is None or s >= start):
                label, start = name, s
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    stream_s = sum(t for n, t in by_name.items() if STREAM_KERNEL in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s, "stream_kernel_s": stream_s,
            "device_ops": [[n, t] for n, t in top],
            "idle_gaps": sorted(([n, t] for n, t in gaps.items()),
                                key=lambda kv: -kv[1])[:10]}


_SPAN_NAMES = {"build", "arbitrate", "finalize", "bam_write"}
