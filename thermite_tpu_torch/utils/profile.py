"""``torch.profiler`` around a run: a Chrome trace file for ``--profile``
and the device's busy time for the on-card smoke test.

``profiled`` traces CPU activity always and CUDA activity when the run is
on a card.  ``traced_to`` also exports what it recorded as one Chrome
trace file (open it in chrome://tracing or Perfetto).  ``device_busy``
reads a recording for the union of each card's kernel and copy intervals,
which against the run's wall time is how far the host holds that card back.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple


@contextmanager
def profiled(cuda: bool):
    """``with profiled(cuda) as prof``: the block runs under
    ``torch.profiler.profile``; ``cuda`` adds the card's kernels and
    copies to the host's operators."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def device_busy(prof) -> Tuple[Dict[int, float], Dict[str, Tuple[float, int]]]:
    """-> ({card index: busy microseconds, the union of that card's kernel
    and copy intervals}; {kernel or copy name: (microseconds, calls), over
    all cards})."""
    from torch.autograd import DeviceType

    spans: List[Tuple[int, float, float, str]] = sorted(
        (e.device_index, e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, reach, by_name = {}, {}, {}
    for card, a, b, name in spans:
        busy[card] = busy.get(card, 0) + max(b - max(a, reach.get(card, a)), 0)
        reach[card] = max(reach.get(card, b), b)
        t, n = by_name.get(name, (0, 0))
        by_name[name] = (t + b - a, n + 1)
    return busy, by_name


@contextmanager
def traced_to(out_dir: str, cuda: bool):
    """The block runs under ``profiled(cuda)``; when it ends without
    raising, its Chrome trace is written into ``out_dir`` (created when
    missing)."""
    with profiled(cuda) as prof:
        yield prof
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out_dir, f"thermite_{os.getpid()}_{time.time_ns()}.trace.json"))
