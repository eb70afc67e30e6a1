"""Explicit device placement for the port.

The alignment path runs on ``cuda`` and raises when no card is present:
a run never falls back to the CPU silently.  ``cpu`` runs only when a
caller asks for it by name (the CPU tests do), and then every kernel
wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )


def resolve(device="cuda") -> torch.device:
    """-> the ``torch.device`` for ``device`` ("cuda", "cuda:N" or
    "cpu"); raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def upload(arr, dev: torch.device) -> torch.Tensor:
    """Host numpy array -> tensor on ``dev``: through pinned memory and
    without blocking for a card; the array itself for the CPU."""
    import numpy as np

    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if dev.type == "cuda":
        if t.numel():
            t = t.pin_memory()
        t = t.to(dev, non_blocking=True)
    return t
