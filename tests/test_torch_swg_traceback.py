"""Kernel 4, the run-length traceback: the plain PyTorch versions equal
the reference's Pallas kernels in interpret mode, bit for bit (tolerance
0: every output is an integer).

The dense form (``swg_traceback_dense_plain``) is held against
``get_traceback_kernel`` on the cases of tests/test_swg_pallas.py (its
reference cases, mixed bands and fuzz seeds 0-3), at a W of 2*bmax + 1
and of 128, with RMAX small enough that walks overflow and equal to a
walk's exact run count.  The gather form (``swg_traceback_plain``) is
held against ``make_traceback_gather_kernel`` in both meta forms.  All
four meta columns are compared; runs only over ``[:nruns]`` of rows with
``nruns >= 0`` (the reference leaves the rest unwritten, the port zeroes
it).  The decoded runs equal the scalar oracle ``SwgExtend`` and the
stream walk of ``swg_stream_plain`` decoded by ``decode_stream_batch``."""

import numpy as np
import pytest
import torch

from test_swg_pallas import pack_pairs
from test_torch_swg_wide import general_case
from thermite_tpu.ops.runs import decode_runs_one, decode_stream_batch
from thermite_tpu.ops.swg_pallas import (
    get_traceback_kernel,
    make_traceback_gather_kernel,
    pack_meta_host,
)
from thermite_tpu.ops.swg_ref import SwgExtend
from thermite_tpu_torch.ops.swg_stream import swg_stream_plain
from thermite_tpu_torch.ops.swg_traceback import (
    SMEM_OPTIN_BYTES,
    _outputs_for_launch,
    swg_traceback,
    swg_traceback_dense,
    swg_traceback_dense_plain,
    swg_traceback_plain,
    traceback_smem_bytes,
)

torch.set_num_threads(1)

BBLK = 8

REFERENCE_CASES = [
    (b"AAAAAAAA", b"AAAAAAAA", 1, 1),
    (b"AAAAATTT", b"AAAAAAAA", 1, 1),
    (b"AAATAAAA", b"AAAAAAAA", 1, 1),
    (b"AAATTTT", b"AAACCTTTT", 2, 3),
]
MIXED_BANDS = [
    (b"ACGTACGT", b"ACGTACGT", 1, 1),
    (b"ACGTACGT", b"ACGGTACGT", 4, 8),
    (b"ACGT", b"TTTTTTTT", 2, 2),
    (b"A", b"A", 1, 1),
    (b"ACGTACGTACGT", b"ACG", 3, 3),
]


def fuzz_pairs(seed, n=24):
    """tests/test_swg_pallas.py::test_fuzz_vs_oracle's problems."""
    rng = np.random.default_rng(seed + 100)
    alpha = b"ACGT"
    pairs = []
    for _ in range(n):
        xl = int(rng.integers(1, 32))
        yl = int(rng.integers(1, 48))
        if rng.random() < 0.6:
            base = bytes(alpha[c] for c in rng.integers(0, 4, max(xl, yl)))
            xs = bytearray(base[:xl])
            ys = bytearray(base[:yl])
            for _ in range(int(rng.integers(0, 5))):
                m = int(rng.integers(0, 3))
                if m == 0 and len(ys) > 1:
                    del ys[int(rng.integers(0, len(ys)))]
                elif m == 1:
                    ys.insert(int(rng.integers(0, len(ys))),
                              alpha[int(rng.integers(0, 4))])
                elif len(ys) > 0:
                    ys[int(rng.integers(0, len(ys)))] = alpha[int(rng.integers(0, 4))]
            xs, ys = bytes(xs), bytes(ys)
        else:
            xs = bytes(alpha[c] for c in rng.integers(0, 4, xl))
            ys = bytes(alpha[c] for c in rng.integers(0, 4, yl))
        pairs.append((xs, ys, int(rng.integers(1, 10)), int(rng.integers(1, 15))))
    return pairs


def _shape(pairs, w_extra=0):
    XMAX = max(8, max(len(p[0]) for p in pairs))
    YMAX = max(8, max(len(p[1]) for p in pairs))
    W = 2 * max(p[2] for p in pairs) + 1 + w_extra
    return XMAX, YMAX, W


def run_dense(pairs, RMAX=64, w_extra=0):
    """-> (reference (meta, runs), port (meta, runs), params)."""
    XMAX, YMAX, W = _shape(pairs, w_extra)
    x, y, params = pack_pairs(pairs, BBLK, XMAX, YMAX, W)
    kern = get_traceback_kernel(BBLK, XMAX, YMAX, W, RMAX=RMAX, interpret=True)
    ref = tuple(np.asarray(v) for v in kern(x, y, params))
    port = swg_traceback_dense_plain(torch.from_numpy(x), torch.from_numpy(y),
                                     torch.from_numpy(params), XMAX, YMAX, RMAX)
    return ref, tuple(v.numpy() for v in port), params


def assert_same(ref, port):
    (rm, rr), (pm, pr) = ref, port
    assert rm.shape == pm.shape and rr.shape == pr.shape
    bad = np.flatnonzero((rm != pm).any(1))
    assert len(bad) == 0, f"meta rows {bad[:5]}: ref {rm[bad[0]]} port {pm[bad[0]]}"
    for k in np.flatnonzero(rm[:, 3] >= 0):
        n = rm[k, 3]
        assert (rr[k, :n] == pr[k, :n]).all(), (k, rr[k, :n], pr[k, :n])
    # the port zeroes every run it did not write
    written = np.minimum(np.where(pm[:, 3] >= 0, pm[:, 3], pr.shape[1]),
                         pr.shape[1])
    past = np.arange(pr.shape[1])[None, :] >= written[:, None]
    assert (pr[past] == 0).all()


def assert_decodes_to_oracle(pairs, port, params):
    pm, pr = port
    for k, (xs, ys, b, d) in enumerate(pairs):
        got = decode_runs_one(pr[k], int(pm[k, 3]), int(pm[k, 0]), int(pm[k, 1]),
                              int(pm[k, 2]), int(params[k, 0]), int(params[k, 1]))
        assert got == SwgExtend(b).extend(xs, ys, b, d), (xs, ys, b, d)


@pytest.mark.parametrize("w_extra", [0, 128 - 2 * 9 - 1])
@pytest.mark.parametrize("case", ["reference", "mixed", "fuzz0", "fuzz1",
                                  "fuzz2", "fuzz3"])
def test_dense_plain_matches_pallas(case, w_extra):
    pairs = {"reference": REFERENCE_CASES, "mixed": MIXED_BANDS}.get(case)
    if pairs is None:
        pairs = fuzz_pairs(int(case[4:]))
    ref, port, params = run_dense(pairs, w_extra=w_extra)
    assert_same(ref, port)
    nr = port[0][: len(pairs), 3]
    assert (nr >= 0).all() and (nr > 0).any()
    assert_decodes_to_oracle(pairs, port, params)


def test_dense_rmax_overflow_and_exact():
    """RMAX below a walk's run count flags the row -1 (its first RMAX
    runs are still written); exactly RMAX runs is a valid walk."""
    pairs = fuzz_pairs(1)
    _, full, _ = run_dense(pairs)
    counts = full[0][: len(pairs), 3]
    rmax = int(np.median(counts))
    ref, port, params = run_dense(pairs, RMAX=rmax)
    assert_same(ref, port)
    nr = port[0][: len(pairs), 3]
    assert (nr == -1).any() and (nr == rmax).any()
    assert ((nr == -1) == (counts > rmax)).all()
    over = np.flatnonzero(nr == -1)
    assert (port[1][over] == full[1][over, :rmax]).all()
    ref1, port1, _ = run_dense(pairs, RMAX=1)
    assert_same(ref1, port1)
    assert ((port1[0][: len(pairs), 3] == 1) == (counts == 1)).all()


def _gather_port(fn, words, rnib, meta, XMAX, YMAX, RMAX):
    out = fn(torch.from_numpy(words), len(words), torch.from_numpy(rnib),
             torch.from_numpy(np.ascontiguousarray(meta)), XMAX, YMAX, RMAX)
    return tuple(v.numpy() for v in out)


@pytest.mark.parametrize("meta_cols", [9, 4])
def test_gather_plain_matches_pallas(meta_cols):
    XMAX, YMAX, W, RMAX = 64, 96, 128, 24
    words, rnib, meta = general_case(40, 2 * BBLK, 0, 40, XMAX, YMAX)
    m = meta if meta_cols == 9 else pack_meta_host(meta)
    kern = make_traceback_gather_kernel(BBLK, XMAX, YMAX, W, RMAX, interpret=True)
    ref = tuple(np.asarray(v) for v in kern(words, np.int32(len(words)), rnib, m))
    port = _gather_port(swg_traceback_plain, words, rnib, m, XMAX, YMAX, RMAX)
    assert_same(ref, port)
    nr = port[0][:, 3]
    assert (nr > 1).any() and (port[0][:, 0] > 0).any()


def test_gather_runs_decode_to_the_stream_walk():
    """On the same problems (bands up to 90, some flanks with many runs),
    every row the run walk completes decodes to the same Alignment as the
    stream walk's fused row, and rows that overflow RMAX are exactly the
    walks with more runs."""
    XMAX, YMAX, SMAX = 96, 128, 240
    words, rnib, meta = general_case(41, 48, 0, 90, XMAX, YMAX)
    meta_out, runs = _gather_port(swg_traceback_plain, words, rnib, meta, XMAX,
                                  YMAX, 4)
    fused = swg_stream_plain(torch.from_numpy(words), len(words),
                             torch.from_numpy(rnib), torch.from_numpy(meta),
                             XMAX, YMAX, SMAX, fused=True).numpy()
    stream = decode_stream_batch(fused, meta[:, 6], meta[:, 3])
    assert (meta_out[:, :3] == fused[:, :3]).all()
    n_ok = 0
    for k in range(len(meta)):
        got = decode_runs_one(runs[k], int(meta_out[k, 3]), *meta_out[k, :3],
                              int(meta[k, 6]), int(meta[k, 3]))
        if got is None:
            ops = [o for o in stream[k].operations if isinstance(o, str)]
            nruns = sum(1 for a, b in zip(ops, ops[1:]) if a != b) + 1
            assert nruns > 4
            continue
        assert got == stream[k], k
        n_ok += 1
    assert 0 < n_ok < len(meta)


def test_wrappers_on_cpu():
    """CPU tensors take the plain versions and launch nothing."""
    launches = (swg_traceback.launches, swg_traceback_dense.launches)
    XMAX, YMAX = 64, 96
    words, rnib, meta = general_case(42, 8, 0, 20, XMAX, YMAX)
    a = _gather_port(swg_traceback, words, rnib, meta, XMAX, YMAX, 24)
    b = _gather_port(swg_traceback_plain, words, rnib, meta, XMAX, YMAX, 24)
    assert all((u == v).all() for u, v in zip(a, b))
    pairs = MIXED_BANDS
    XM, YM, W = _shape(pairs)
    x, y, params = (torch.from_numpy(v) for v in pack_pairs(pairs, BBLK, XM, YM, W))
    a = swg_traceback_dense(x, y, params, XM, YM)
    b = swg_traceback_dense_plain(x, y, params, XM, YM)
    assert all((u == v).all() for u, v in zip(a, b))
    assert (swg_traceback.launches, swg_traceback_dense.launches) == launches


def test_launch_shape_limit():
    """One problem's shared memory must fit the opt-in limit: every
    window the gather form accepts (XMAX, YMAX <= 512) does at RMAX 64;
    a run buffer past the limit is refused before any launch."""
    assert traceback_smem_bytes(512, 512, 64, 32) <= SMEM_OPTIN_BYTES
    _outputs_for_launch(4, 512, 512, 64, 1023, "cpu")
    with pytest.raises(ValueError, match="shared memory"):
        _outputs_for_launch(4, 512, 512, 1 << 16, 1023, "cpu")
    with pytest.raises(ValueError, match="slot class"):
        _outputs_for_launch(4, 2048, 64, 24, 1023, "cpu")
