"""Explicit device placement for the port.

The alignment path runs on ``cuda`` and raises when no card is present:
a run never falls back to the CPU silently.  ``cpu`` runs only when a
caller asks for it by name (the CPU tests do), and then every kernel
wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """-> the ``torch.device`` for ``device`` ("cuda", "cuda:N" or
    "cpu"); raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
