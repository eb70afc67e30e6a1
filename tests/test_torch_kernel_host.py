"""The CUDA kernels' scalar logic, built for the host with g++.

csrc/swg_stream.cuh keeps meta unpacking, the nibble gather, the slot
classes and shared-memory sizing of a launch, the direction-plane
layout, the traceback walk, code packing and header packing as
__host__ __device__ functions; csrc/swg_stream_host.cpp exposes them
with a C interface.  They are held equal to the plain PyTorch version on
the fuzz, general-band and certificate rows, for every slot class the
kernels instantiate (tolerance 0).  This is the only check of kernel
code that runs without a GPU."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_swg_stream import _fuzz_case, _narrow_case
from test_torch_swg_wide import general_case
from thermite_tpu_torch.ops import swg_stream as ss
from thermite_tpu_torch.ops.swg_traceback import _walk_runs_plain, traceback_smem_bytes
from thermite_tpu_torch.ops.layout import _WPAD, pack_meta_host, smax_for

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "thermite_tpu_torch", "csrc",
)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not installed")
    out = str(tmp_path_factory.mktemp("swg_host") / "libswg_host.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared", "-fPIC",
         "-o", out, os.path.join(CSRC, "swg_stream_host.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(out)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.thermite_swg_host_unpack_meta.argtypes = [p, i32, i64, p]
    lib.thermite_swg_host_nib_at.argtypes = [p, i64, p, i64, p]
    lib.thermite_swg_host_walk.restype = i32
    lib.thermite_swg_host_walk.argtypes = [
        p, i32, i32, p, p, p, p, p, i64, i32, p, p,
    ]
    lib.thermite_swg_host_walk_runs.restype = i32
    lib.thermite_swg_host_walk_runs.argtypes = [
        p, i32, i32, p, p, p, i64, i32, i32, p, p,
    ]
    lib.thermite_swg_host_slots_for.restype = i32
    lib.thermite_swg_host_slots_for.argtypes = [i32, i32]
    lib.thermite_swg_host_smem.restype = i32
    lib.thermite_swg_host_smem.argtypes = [i32, i32, i32, i32, i32, p]
    return lib


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.mark.parametrize("meta_cols", [9, 4])
def test_unpack_meta(host_lib, meta_cols):
    _, _, meta, _, _ = _fuzz_case(4, 64, 64)
    rows = meta if meta_cols == 9 else pack_meta_host(meta)
    rows = np.ascontiguousarray(rows, np.int32)
    out = np.zeros((len(rows), 8), np.int64)
    host_lib.thermite_swg_host_unpack_meta(_ptr(rows), meta_cols, len(rows),
                                           _ptr(out))
    m = ss.meta9(torch.from_numpy(rows)).numpy().astype(np.int64)
    want = np.stack([8 * m[:, 0] + m[:, 1], m[:, 4] + _WPAD, m[:, 2],
                     m[:, 5], m[:, 3], m[:, 6], m[:, 7], m[:, 8]], 1)
    assert (out == want).all()


def test_nib_at(host_lib):
    rng = np.random.default_rng(2)
    words = rng.integers(-(1 << 31), 1 << 31, 300, dtype=np.int64)
    words = words.astype(np.int32)
    pos = rng.integers(-100, 8 * 300 + 100, 5000).astype(np.int64)
    out = np.zeros(len(pos), np.int32)
    host_lib.thermite_swg_host_nib_at(_ptr(words), len(words), _ptr(pos),
                                      len(pos), _ptr(out))
    one = torch.ones(len(pos), dtype=torch.int64)
    want = ss.gather_span_nib(torch.from_numpy(words), torch.from_numpy(pos),
                              one, 1)[:, 0]
    assert (out == want.numpy()).all()


def _planes(dirs: np.ndarray) -> np.ndarray:
    """(N, Y, L) direction codes -> (N, Y, 2*SLOTS) ballot words: word
    2k+b has bit `lane` set when bit b of slot lane*SLOTS + k is set."""
    N, Y, L = dirs.shape
    slots = L // 32
    d = dirs.astype(np.uint64).reshape(N, Y, 32, slots)
    lanes = np.arange(32, dtype=np.uint64)[None, None, :, None]
    out = np.zeros((N, Y, slots, 2), np.uint64)
    for b in range(2):
        out[..., b] = (((d >> np.uint64(b)) & np.uint64(1)) << lanes).sum(2)
    return out.reshape(N, Y, 2 * slots).astype(np.uint32)


def _walk_case(host_lib, words, rnib, meta, XMAX, YMAX, SMAX, slots=None):
    m9 = torch.from_numpy(np.ascontiguousarray(meta))
    x, y = ss._windows(torch.from_numpy(words), torch.from_numpy(rnib), m9,
                       XMAX, YMAX)
    xlen, ylen, band, xdrop = (m9[:, k] for k in (6, 3, 7, 8))
    L = 32 * (slots or ss.stream_slots(int(band.max()), XMAX))
    ms, mi, mj, cert, dirs = ss._forward_plain(x, y, xlen, ylen, band, xdrop, L)
    c, bad, streams = ss._walk_plain(dirs, mi, mj, band, SMAX)
    ns = torch.where(bad, -1, torch.where(cert, c, -2 - c))
    want_hdr = ss.pack_stream_hdr(ms, mi, mj, ns).numpy()

    planes = np.ascontiguousarray(_planes(dirs.numpy()))
    n = len(meta)
    hdr = np.zeros((n, 2), np.int32)
    got = np.zeros((n, SMAX // 16), np.int32)
    arrs = [a.numpy().astype(np.int32) for a in (ms, mi, mj, band)]
    cert_u8 = cert.numpy().astype(np.uint8)
    rc = host_lib.thermite_swg_host_walk(
        _ptr(planes), L // 32, YMAX, *[_ptr(a) for a in arrs], _ptr(cert_u8),
        n, SMAX, _ptr(hdr), _ptr(got),
    )
    assert rc == 0
    assert (hdr == want_hdr).all()
    assert (got == streams.numpy()).all()
    return ns.numpy()


@pytest.mark.parametrize("seed,seg", [(0, 64), (3, 64), (0, 32), (5, 32)])
def test_walk_and_header_fuzz(host_lib, seed, seg):
    words, rnib, meta, XMAX, YMAX = _fuzz_case(seed, seg, 64)
    ns = _walk_case(host_lib, words, rnib, meta, XMAX, YMAX, 256)
    assert (ns > 0).any()


def test_walk_and_header_certificate_and_short_smax(host_lib):
    """Certificate failures (-2-c) and walks longer than SMAX (-1, codes
    past the stream dropped) pack the same in both."""
    words, rnib, meta = _narrow_case(7, 64)
    ns = _walk_case(host_lib, words, rnib, meta, 96, 128, 384)
    assert (ns <= -2).any()
    ns = _walk_case(host_lib, words, rnib, meta, 96, 128, 48)
    assert (ns == -1).any() and (ns >= 0).any()


@pytest.mark.parametrize("slots", [4, 8, 16, 32])
def test_walk_and_header_general_band(host_lib, slots):
    """dir_at<SLOTS> / walk<SLOTS> of the general kernel's classes: the
    planes of a forward pass over 32*SLOTS slots (more than the bands
    need: extra slots are never computed), walked on the host."""
    words, rnib, meta = general_case(20 + slots, 24, 32, 110, 96, 128)
    ns = _walk_case(host_lib, words, rnib, meta, 96, 128, 240, slots=slots)
    assert (ns > 0).any()


def _runs_case(host_lib, words, rnib, meta, XMAX, YMAX, slots, steps, rmax):
    """walk_runs<SLOTS> on the planes of a plain forward pass ==
    _walk_runs_plain on its directions: nruns and every run slot."""
    m9 = torch.from_numpy(np.ascontiguousarray(meta))
    x, y = ss._windows(torch.from_numpy(words), torch.from_numpy(rnib), m9,
                       XMAX, YMAX)
    xlen, ylen, band, xdrop = (m9[:, k] for k in (6, 3, 7, 8))
    L = 32 * slots
    _, mi, mj, _, dirs = ss._forward_plain(x, y, xlen, ylen, band, xdrop, L)
    want_n, want_runs = _walk_runs_plain(dirs, mi, mj, band, steps, rmax)
    planes = np.ascontiguousarray(_planes(dirs.numpy()))
    n = len(meta)
    runs = np.zeros((n, rmax), np.int32)
    nruns = np.zeros(n, np.int32)
    arrs = [a.numpy().astype(np.int32) for a in (mi, mj, band)]
    rc = host_lib.thermite_swg_host_walk_runs(
        _ptr(planes), slots, YMAX, *[_ptr(a) for a in arrs], n, steps, rmax,
        _ptr(runs), _ptr(nruns),
    )
    assert rc == 0
    assert (nruns == want_n.numpy()).all()
    assert (runs == want_runs.numpy()).all()
    return nruns


@pytest.mark.parametrize("slots,steps,rmax", [
    (1, 0, 24), (2, 0, 3), (4, 0, 64), (8, 20, 24), (16, 0, 1), (32, 0, 6),
])
def test_walk_runs(host_lib, slots, steps, rmax):
    """Run boundaries (M and S are separate ops), the step bound
    (XMAX + YMAX + 2, or 20 to cut walks short) and RMAX overflow (-1,
    the first RMAX runs still written; exactly RMAX runs is valid), for
    every slot class of kernel 4."""
    if slots <= 2:
        words, rnib, meta, XMAX, YMAX = _fuzz_case(slots, 32 * (slots + 1), 64)
    else:
        words, rnib, meta = general_case(30 + slots, 48, 32, 110, 96, 128)
        XMAX, YMAX = 96, 128
    steps = steps or XMAX + YMAX + 2
    nr = _runs_case(host_lib, words, rnib, meta, XMAX, YMAX, slots, steps, rmax)
    assert (nr >= min(rmax, 2)).any()
    if steps < XMAX + YMAX + 2 or rmax < 8:
        assert (nr == -1).any()
    if rmax < 8:
        assert (nr == rmax).any()


def test_slot_classes_match_python(host_lib):
    for xmax in (1, 20, 31, 32, 63, 64, 96, 200, 255, 256, 511, 512):
        for band in range(0, 1024, 7):
            assert host_lib.thermite_swg_host_slots_for(band, xmax) == \
                ss.slots_per_lane(band, xmax), (band, xmax)


def test_shared_memory_fits_every_accepted_shape(host_lib):
    """Warps per block follow from the per-warp shared memory, so every
    window the reference accepts (XMAX, YMAX <= 512, SMAX up to
    smax_for(512, 512)) launches within the 227 KB opt-in limit."""
    warps = np.zeros(1, np.int32)
    pw = smax_for(_WPAD, _WPAD) // 16
    for slots in (2, 4, 8, 16, 32):
        for ymax in (32, 128, 160, 256, 512):
            words = host_lib.thermite_swg_host_smem(_WPAD, ymax, pw, slots, 4,
                                                    _ptr(warps))
            assert words == ((ymax + 1) * 2 * slots + pw + (_WPAD + 3) // 4
                             + (ymax + 3) // 4)
            assert 1 <= warps[0] <= 4
            assert warps[0] * words * 4 <= 232448
    # the direction planes alone at SLOTS 32, YMAX 512: one warp per block
    host_lib.thermite_swg_host_smem(_WPAD, _WPAD, pw, 32, 4, _ptr(warps))
    assert warps[0] == 1
    # kernel 4 sizes a warp the same way, with its RMAX runs for pw
    for slots, ymax, rmax in ((1, 128, 24), (4, 160, 24), (32, 512, 64)):
        words = host_lib.thermite_swg_host_smem(96, ymax, rmax, slots, 4,
                                                _ptr(warps))
        assert 4 * words == traceback_smem_bytes(96, ymax, rmax, slots)
