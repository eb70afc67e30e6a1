"""The stream kernels' roofline: the band-cell count on hand-made rows,
the frozen meta decoder against the rows the program builds, and the
count against the program's plain DP where no X-drop stops it."""

import numpy as np
import pytest
import torch

from benchmark.metrics import swg_stream_roofline as R


def _brute(ylen, xlen, band, YMAX):
    n = 0
    for j in range(1, min(ylen, YMAX) + 1):
        row0 = max(j - band, 0)
        n += sum(1 for t in range(2 * band + 1) if t <= xlen - row0)
    return n


def test_band_cells_hand_made():
    rows = [(90, 90, 15), (0, 0, 1), (10, 90, 15), (120, 40, 15), (5, 0, 3),
            (100, 90, 60), (1, 1, 1)]
    meta = np.zeros((len(rows), 9), np.int32)
    for i, (y, x, b) in enumerate(rows):
        meta[i, [3, 6, 7]] = (y, x, b)
    for YMAX in (128, 96):
        want = sum(_brute(y, x, b, YMAX) for y, x, b in rows)
        assert R.band_cells(meta, YMAX) == want
    # padding rows (the pipeline's empty problems) add nothing
    assert R.band_cells(meta[[1]], 128) == 0


def test_peak():
    assert R.PEAK_CELLS_S == pytest.approx(132 * 64 * 1.98e9 * 2 / 3)
    assert 11.1e12 < R.PEAK_CELLS_S < 11.2e12


def _random_meta(n, rng):
    from thermite_tpu_torch.ops.layout import meta_row

    rows = []
    for _ in range(n):
        xlen = int(rng.integers(0, 96))
        band = int(rng.integers(1, 31))
        ylen = int(rng.integers(0, xlen + band + 2))
        rows.append(meta_row(int(rng.integers(0, 1000)), int(rng.choice([-1, 1])),
                             ylen, int(rng.integers(0, 500)),
                             int(rng.choice([-1, 1])), xlen, band,
                             int(rng.integers(1, 4000))))
    return np.array(rows, np.int32)


def test_frozen_meta_decoder_matches_program():
    from thermite_tpu_torch.ops.layout import pack_meta_host
    from thermite_tpu_torch.ops.swg_stream import meta9

    m = _random_meta(300, np.random.default_rng(3))
    packed = pack_meta_host(m)
    want = meta9(torch.from_numpy(packed)).numpy()
    assert (R.meta9(packed) == want).all()
    assert (R.meta9(m) == m).all()


def test_count_matches_plain_dp_without_xdrop():
    from thermite_tpu_torch.ops.layout import (pack_reads_nib_host,
                                               pack_text_nib_host)
    from thermite_tpu_torch.ops.swg_stream import dp_work_plain

    rng = np.random.default_rng(5)
    m = _random_meta(64, rng)
    m[:, 8] = 4000  # X-drop never stops a problem
    m[:, 0] = (m[:, 0] + 2000) // 8  # anchors well inside the text
    text = np.frombuffer(rng.choice(list(b"ACGT"), 20000).astype(np.uint8)
                         .tobytes(), np.uint8)
    reads = np.frombuffer(rng.choice(list(b"ACGT"), 4000).astype(np.uint8)
                          .tobytes(), np.uint8)
    tn = torch.from_numpy(pack_text_nib_host(text))
    rn = torch.from_numpy(pack_reads_nib_host(reads))
    XMAX, YMAX = 96, 160
    _, cells = dp_work_plain(tn, tn.shape[0], rn, torch.from_numpy(m), XMAX, YMAX)
    assert R.band_cells(m, YMAX) == int(cells.sum())


def test_launches_of_a_pipeline_decode(tiny_root):
    """The rows the program's pipeline launches (captured by the traced
    run's wrapper) decode to real problems within the launch shapes."""
    import time

    from benchmark import harness
    from benchmark.trace import spans_and_launches
    from thermite_tpu_torch.align.batch import BatchAligner
    from thermite_tpu_torch.ops.swg_stream import meta9

    spec, cell, cfg, traffic = harness.find_cell(tiny_root, "tiny.se90")
    genome = harness.ensure_caches(tiny_root, cfg)
    index = harness.port_index(cfg, genome)
    aligner = BatchAligner(index, harness.port_opts(cfg), device="cpu")
    recs = harness.generator(tiny_root, "windows").make_batch(
        genome, traffic, 11, 0, 0)
    launches = []
    with spans_and_launches(aligner, launches):
        aligner.align_batch_emit(recs, True)
    assert launches
    for l in launches:
        m = l["meta"].numpy()
        assert (R.meta9(m) == meta9(l["meta"]).numpy()).all()
        d = R.meta9(m)
        real = d[:, 3] > 0
        assert real.any() and (d[real, 6] <= l["XMAX"]).all()
        assert R.band_cells(m, l["YMAX"]) > 0
    assert aligner.stats.stage.__func__ is type(aligner.stats).stage
