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


def release_pinned(devs) -> None:
    """Hand torch's cached pinned host blocks back to the system once
    every copy on the CUDA devices of ``devs`` is done.  For after a
    one-off upload (the resident text): its staging block is of a size
    class that no chunk's copy takes, and would stay resident for the
    process's life."""
    cuda = {d for d in devs if d.type == "cuda"}
    if not cuda:
        return
    for d in cuda:
        torch.cuda.synchronize(d)
    empty = (getattr(torch.accelerator, "empty_host_cache", None)
             or getattr(torch._C, "_host_emptyCache", None))
    if empty is not None:
        empty()


STAGE_BYTES = 64 << 20  # one pinned staging buffer of a large upload


def upload(arr, dev: torch.device) -> torch.Tensor:
    """Host numpy array -> tensor on ``dev``: through pinned memory and
    without blocking for a card; the array itself for the CPU.  An array
    larger than ``STAGE_BYTES`` (a genome-scale text, often a read-only
    memory map) goes through ``_upload_staged`` instead, and the call
    returns once it is on the card."""
    import numpy as np

    if dev.type == "cuda" and arr.nbytes > STAGE_BYTES:
        return _upload_staged(arr, dev)
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if dev.type == "cuda":
        if t.numel():
            t = t.pin_memory()
        t = t.to(dev, non_blocking=True)
    return t


def _upload_staged(arr, dev: torch.device) -> torch.Tensor:
    """A C-contiguous host array to the card through two pinned buffers
    of ``STAGE_BYTES`` in turn: the host fills one while the card copies
    from the other.  No host copy of the whole array is made (a
    writeable copy, then a pinned one, would double a 3.2 GB text in
    host memory)."""
    import numpy as np

    src = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    out = torch.empty(src.size, dtype=torch.uint8, device=dev)
    bufs = [torch.empty(STAGE_BYTES, dtype=torch.uint8).pin_memory()
            for _ in range(2)]
    done = [None, None]
    with torch.cuda.device(dev):
        for k, a in enumerate(range(0, src.size, STAGE_BYTES)):
            b, i = min(a + STAGE_BYTES, src.size), k % 2
            if done[i] is not None:
                done[i].synchronize()
            bufs[i][: b - a].numpy()[:] = src[a:b]
            out[a:b].copy_(bufs[i][: b - a], non_blocking=True)
            done[i] = torch.cuda.Event()
            done[i].record()
        torch.cuda.current_stream(dev).synchronize()
    return out.view(dtype).view(arr.shape)
