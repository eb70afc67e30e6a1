"""swg_forward_plain == the reference's forward-scores Pallas kernel
(get_forward_gather_kernel, interpret mode), bit for bit: tolerance 0,
every output is an integer.  Bands up to 15, 63 and 127 (W 128 and 256),
both meta forms, padding rows, and the wrapper's CPU dispatch."""

import numpy as np
import pytest
import torch

from test_torch_swg_wide import general_case
from thermite_tpu.ops.swg_pallas import get_forward_gather_kernel, pack_meta_host
from thermite_tpu_torch.ops.swg_forward import swg_forward, swg_forward_plain
from thermite_tpu_torch.ops.swg_stream import swg_stream_plain

torch.set_num_threads(1)

BBLK = 8

CASES = {
    # name: (seed, band_lo, band_hi, XMAX, YMAX, W)
    "band<=15": (10, 0, 15, 64, 96, 128),
    "band<=63": (11, 0, 63, 96, 128, 128),
    "band<=127": (12, 30, 127, 128, 192, 256),
}


def _reference(words, rnib, meta, XMAX, YMAX, W):
    kern = get_forward_gather_kernel(BBLK, XMAX, YMAX, W, interpret=True)
    return np.asarray(kern(words, np.int32(len(words)), rnib, meta))


def _port(words, rnib, meta, XMAX, YMAX, fn=swg_forward_plain):
    out = fn(torch.from_numpy(words), len(words), torch.from_numpy(rnib),
             torch.from_numpy(np.ascontiguousarray(meta)), XMAX, YMAX)
    return out.numpy()


@pytest.mark.parametrize("meta_cols", [9, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_forward_pallas(case, meta_cols):
    seed, lo, hi, XMAX, YMAX, W = CASES[case]
    words, rnib, meta = general_case(seed, 3 * BBLK, lo, hi, XMAX, YMAX)
    m = meta if meta_cols == 9 else pack_meta_host(meta)
    ref = _reference(words, rnib, m, XMAX, YMAX, W)
    port = _port(words, rnib, m, XMAX, YMAX)
    bad = np.flatnonzero((ref != port).any(1))
    assert len(bad) == 0, (
        f"{len(bad)} rows differ; first {bad[:3]}: meta={meta[bad[0]]} "
        f"ref={ref[bad[0]]} port={port[bad[0]]}"
    )
    assert (ref[:, 0] > 5).any() and (ref[:, 3] == 0).all()


def test_scores_equal_the_stream_headers():
    """The forward kernel is the stream kernel's DP without the walk:
    [score, max_i, max_j] equal the stream rows' headers; padding rows
    (dirs +1, band 1, empty windows) score 0 at cell (0, 0)."""
    words, rnib, meta = general_case(13, 20, 0, 80, 96, 128)
    pad = np.zeros((4, 9), np.int32)
    pad[:, 2] = pad[:, 5] = pad[:, 7] = pad[:, 8] = 1
    meta = np.concatenate([meta, pad])
    fwd = _port(words, rnib, meta, 96, 128)
    rows = swg_stream_plain(
        torch.from_numpy(words), len(words), torch.from_numpy(rnib),
        torch.from_numpy(meta), 96, 128, 240, fused=True,
    ).numpy()
    assert (fwd[:, :3] == rows[:, :3]).all()
    assert (fwd[-4:] == 0).all()


def test_wrapper_cpu_dispatches_to_plain():
    words, rnib, meta = general_case(14, 16, 0, 40, 64, 96)
    launches = swg_forward.launches
    a = _port(words, rnib, meta, 64, 96, fn=swg_forward)
    b = _port(words, rnib, meta, 64, 96)
    assert (a == b).all()
    assert swg_forward.launches == launches  # CPU tensors launch no kernel
    with pytest.raises(ValueError):
        _port(words, rnib, meta, 64, 600, fn=swg_forward)
