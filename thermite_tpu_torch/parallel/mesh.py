"""Several devices of one host for one batch: the rows of a launch split
over a mesh.

The workload is data-parallel over extension problems with read-only
shared state, so a mesh needs no communication between devices: the
nibble-packed reference text and a chunk's read block are replicated on
every device, the problem meta rows are split, each device gathers its
own windows and runs its own launch of the port's kernel wrapper
(``ops/swg_stream.py::swg_stream``, ``ops/swg_forward.py::swg_forward``)
on its current stream, and the host merges the rows in input order.  The
counterpart of the reference's ``thermite_tpu/parallel/mesh.py``, whose
``shard_map`` wrappers cut the rows into contiguous blocks.

A mesh is a tuple of ``torch.device``.  Rows are split round-robin:
device ``d`` of ``n`` takes rows ``d::n``, so row ``r`` lives on device
``r % n`` at local row ``r // n``.  The batch pipeline submits rows
ordered by column count, because problems that share a warp should be
alike; a round-robin cut keeps that order on every device and gives each
device the same share of the long rows, where a contiguous cut would give
one device all of them.  The outputs do not depend on the cut.

The same device may stand in a mesh more than once: it then takes that
many launches, and a replicated array is uploaded to it once.  That is
how the split and merge run with the real kernels on a host with one
card, and how a CPU mesh of N (N entries of the CPU device) runs them in
the tests.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..ops.layout import pack_reads_nib_host, pack_text_nib_host
from ..ops.swg_forward import swg_forward
from ..ops.swg_stream import swg_stream

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The first ``n_devices`` local devices of ``device``'s type (all of
    them when None); raises ValueError when fewer exist, RuntimeError for
    cards on a host without one.  For ``"cpu"`` a mesh of N is N entries
    of the CPU device."""
    if torch.device(device).type == "cuda":
        _device.require_cuda()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [_device.resolve("cpu")] * max(n_devices or 1, 1)
    if n_devices is None:
        return tuple(devices)
    if n_devices < 1 or len(devices) < n_devices:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only "
            f"{len(devices)} local device(s) are available"
        )
    return tuple(devices[:n_devices])


def check_mesh(mesh: Sequence) -> Mesh:
    """``mesh`` as a tuple of resolved devices; raises ValueError for an
    empty mesh and for one that mixes the CPU with a card."""
    mesh = tuple(_device.resolve(d) for d in mesh)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in mesh}) > 1:
        raise ValueError(f"a mesh is all cards or all CPU, got {mesh}")
    return mesh


def split_rows(n_rows: int, n_dev: int) -> List[np.ndarray]:
    """Row indices of each device's part: device d takes rows d::n_dev."""
    return [np.arange(d, n_rows, n_dev) for d in range(n_dev)]


def merge_rows(parts: Sequence[np.ndarray], n_rows: int,
               index: Optional[Sequence[np.ndarray]] = None) -> np.ndarray:
    """The devices' row blocks back in input order: (n_rows, ...) with
    part d at ``index[d]`` (the rows of ``split_rows(n_rows, len(parts))``
    when not given, as strided slices: a plain copy for a mesh of one)."""
    if index is None:
        index = [slice(d, n_rows, len(parts)) for d in range(len(parts))]
    out = np.empty((n_rows,) + parts[0].shape[1:], parts[0].dtype)
    for rows, part in zip(index, parts):
        out[rows] = part
    return out


def replicate(mesh: Mesh, arr: np.ndarray) -> List[torch.Tensor]:
    """``arr`` on every device of the mesh, one tensor per entry; a device
    that stands in the mesh more than once is uploaded to once."""
    by_dev = {}
    for d in mesh:
        if d not in by_dev:
            by_dev[d] = _device.upload(arr, d)
    return [by_dev[d] for d in mesh]


def scatter_rows(mesh: Mesh, rows: np.ndarray) -> List[torch.Tensor]:
    """Each device's part of ``rows`` (``split_rows``), uploaded to it."""
    n = len(mesh)
    return [_device.upload(np.ascontiguousarray(rows[d::n]), dev)
            for d, dev in enumerate(mesh)]


def sharded_stream(mesh: Mesh, texts, reads, metas, XMAX: int, YMAX: int,
                   SMAX: int, band_max=None, fused: bool = False) -> list:
    """One ``swg_stream`` call per mesh entry, on that device's replica of
    the text (``texts[d]``) and of the read block (``reads[d]``) and its
    part of the meta rows (``metas[d]``), each on its device's current
    stream.  -> the per-device outputs, resident where they were
    computed: (hdr, streams) pairs, or the fused rows.  The counterpart of
    the reference's ``sharded_packed_stream_split_kernel``,
    ``sharded_stream_split_kernel`` and, fused, ``sharded_stream_kernel``.
    Pass the ``band_max`` of the whole launch, so that every device runs
    the same kernel shape."""
    return [swg_stream(texts[d], texts[d].shape[0], reads[d], metas[d], XMAX,
                       YMAX, SMAX, band_max=band_max, fused=fused)
            for d in range(len(mesh))]


def sharded_forward(mesh: Mesh, texts, reads, metas, XMAX: int, YMAX: int,
                    band_max=None) -> list:
    """One ``swg_forward`` call per mesh entry, as ``sharded_stream``; ->
    the per-device (rows, 4) score blocks.  The counterpart of the
    reference's ``sharded_swg_gather_kernel``."""
    return [swg_forward(texts[d], texts[d].shape[0], reads[d], metas[d], XMAX,
                        YMAX, band_max=band_max)
            for d in range(len(mesh))]


def dp_gather_align_step(mesh: Mesh, XMAX: int, YMAX: int) -> Callable:
    """The multi-device layout as one step: text and read block
    replicated, problems split over the mesh, forward scores per device,
    and the one global statistic summed on the host (devices and hosts
    share nothing else, so there is no collective to run).

    step(ref_text (G,) u8, reads (B, RPAD) u8, meta (N, 9) i32, min_score)
    -> (score, max_i, max_j (N,) i32 in input order; n_pass: how many
    scores reach ``min_score``)"""
    mesh = check_mesh(mesh)

    def step(ref_text, reads, meta, min_score):
        meta = np.asarray(meta, np.int32)
        texts = replicate(mesh, pack_text_nib_host(np.asarray(ref_text)))
        blocks = replicate(
            mesh, pack_reads_nib_host(np.asarray(reads).reshape(-1)))
        bmax = int(meta[:, 7].max(initial=0))
        parts = sharded_forward(mesh, texts, blocks, scatter_rows(mesh, meta),
                                XMAX, YMAX, band_max=bmax)
        n_pass = sum(int((p[:, 0] >= int(min_score)).sum()) for p in parts)
        out = merge_rows([p.cpu().numpy() for p in parts], len(meta))
        return out[:, 0], out[:, 1], out[:, 2], n_pass

    return step
