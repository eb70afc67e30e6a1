"""The CUDA kernels' scalar logic, built for the host with g++.

csrc/swg_stream.cuh keeps meta unpacking, the nibble gather, the group
shapes (LANES lanes a problem x SLOTS band slots a lane) and
shared-memory sizing of a launch, the direction-plane layout (one cell
of dir_bytes(SLOTS) bytes per lane and column), the traceback walks,
code packing and header packing as __host__ __device__ functions;
csrc/swg_stream_host.cpp exposes them with a C interface.  They are held
equal to the plain PyTorch version on the fuzz, general-band and
certificate rows, for every LANES x SLOTS class the kernels instantiate
(tolerance 0).  This is the only check of kernel
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
        p, i32, i32, i32, p, p, p, p, p, i64, i32, p, p,
    ]
    lib.thermite_swg_host_walk_runs.restype = i32
    lib.thermite_swg_host_walk_runs.argtypes = [
        p, i32, i32, i32, p, p, p, i64, i32, i32, p, p,
    ]
    lib.thermite_swg_host_dir_at.restype = i32
    lib.thermite_swg_host_dir_at.argtypes = [p, i32, i32, i32, i64, p]
    lib.thermite_swg_host_slots_for.restype = i32
    lib.thermite_swg_host_slots_for.argtypes = [i32, i32]
    lib.thermite_swg_host_stream_group.restype = i32
    lib.thermite_swg_host_stream_group.argtypes = [i32, i32]
    lib.thermite_swg_host_smem.restype = i32
    lib.thermite_swg_host_smem.argtypes = [i32, i32, i32, i32, i32, i32, p]
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


# every LANES x SLOTS class a kernel instantiates: the stream kernels'
# groups, and 32 lanes x 1..32 slots of the forward and run-length kernels
GROUPS = [(8, 4), (16, 4), (32, 1), (32, 2), (32, 4), (32, 8),
          (32, 16), (32, 32)]


def _planes(dirs: np.ndarray, lanes: int, slots: int) -> np.ndarray:
    """(N, Y, L) direction codes -> (N, Y, lanes, dir_bytes(slots)) bytes:
    lane s // slots holds slot s at bits 2 * (s % slots) of its
    little-endian cell, as each lane of the kernel stores it.  Slots past
    lanes * slots must hold no direction (they are never computed)."""
    N, Y, L = dirs.shape
    n = lanes * slots
    assert not dirs[:, 1:, n:].any()
    d = np.zeros((N, Y, n), np.uint64)
    d[:, :, : min(L, n)] = dirs[:, :, :n]
    d = d.reshape(N, Y, lanes, slots)
    shifts = (2 * np.arange(slots, dtype=np.uint64))[None, None, None, :]
    cells = (d << shifts).sum(3, dtype=np.uint64)
    bpl = ss.dir_bytes(slots)
    out = np.ascontiguousarray(cells.astype("<u8")).view(np.uint8)
    return np.ascontiguousarray(out.reshape(N, Y, lanes, 8)[..., :bpl])


def _span(lanes: int, slots: int) -> int:
    """Slot span of the plain forward pass (a multiple of 32) that covers
    a group's lanes * slots."""
    return 32 * ((lanes * slots + 31) // 32)


def _walk_case(host_lib, words, rnib, meta, XMAX, YMAX, SMAX, group=None):
    m9 = torch.from_numpy(np.ascontiguousarray(meta))
    x, y = ss._windows(torch.from_numpy(words), torch.from_numpy(rnib), m9,
                       XMAX, YMAX)
    xlen, ylen, band, xdrop = (m9[:, k] for k in (6, 3, 7, 8))
    lanes, slots = group or ss.stream_group(int(band.max()), XMAX)
    ms, mi, mj, cert, dirs = ss._forward_plain(x, y, xlen, ylen, band, xdrop,
                                               _span(lanes, slots))
    c, bad, streams = ss._walk_plain(dirs, mi, mj, band, SMAX)
    ns = torch.where(bad, -1, torch.where(cert, c, -2 - c))
    want_hdr = ss.pack_stream_hdr(ms, mi, mj, ns).numpy()

    planes = _planes(dirs.numpy(), lanes, slots)
    n = len(meta)
    hdr = np.zeros((n, 2), np.int32)
    got = np.zeros((n, SMAX // 16), np.int32)
    arrs = [a.numpy().astype(np.int32) for a in (ms, mi, mj, band)]
    cert_u8 = cert.numpy().astype(np.uint8)
    rc = host_lib.thermite_swg_host_walk(
        _ptr(planes), lanes, slots, YMAX, *[_ptr(a) for a in arrs],
        _ptr(cert_u8), n, SMAX, _ptr(hdr), _ptr(got),
    )
    assert rc == 0
    assert (hdr == want_hdr).all()
    assert (got == streams.numpy()).all()
    return ns.numpy()


@pytest.mark.parametrize("group", GROUPS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_dir_at_reads_each_lanes_cell(host_lib, group):
    """dir_at<LANES, SLOTS> reads slot s at cell [j][s // SLOTS], bits
    2 * (s % SLOTS): random codes in every slot of every column."""
    lanes, slots = group
    rng = np.random.default_rng(lanes * 100 + slots)
    ymax = 37
    dirs = rng.integers(0, 4, (5, ymax + 1, lanes * slots)).astype(np.int8)
    planes = _planes(dirs, lanes, slots)
    assert planes.shape[2:] == (lanes, ss.dir_bytes(slots))
    out = np.zeros(dirs.shape, np.uint8)
    assert host_lib.thermite_swg_host_dir_at(_ptr(planes), lanes, slots, ymax,
                                             len(dirs), _ptr(out)) == 0
    assert (out == dirs).all()
    assert host_lib.thermite_swg_host_dir_at(_ptr(planes), 8, 3, ymax, 1,
                                             _ptr(out)) == -1


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


@pytest.mark.parametrize("group", [
    pytest.param((32, 4), id="4"), pytest.param((32, 8), id="8"),
    pytest.param((32, 16), id="16"), pytest.param((32, 32), id="32"),
])
def test_walk_and_header_general_band(host_lib, group):
    """dir_at / walk of the general kernel's group shapes: the planes of
    a forward pass over LANES * SLOTS slots (more than the bands need:
    extra slots are never computed), walked on the host."""
    words, rnib, meta = general_case(20 + group[1], 24, 32, 110, 96, 128)
    ns = _walk_case(host_lib, words, rnib, meta, 96, 128, 240, group=group)
    assert (ns > 0).any()


@pytest.mark.parametrize("group,band_hi", [((8, 4), 15), ((16, 4), 31)])
def test_walk_and_header_packed_groups(host_lib, group, band_hi):
    """The packed kernel's two group shapes on bands up to 15 and up to
    31: four and two problems a warp."""
    words, rnib, meta = general_case(40 + band_hi, 24, 0, band_hi, 96, 128)
    assert ss.stream_group(band_hi, 96) == group
    ns = _walk_case(host_lib, words, rnib, meta, 96, 128, 240)
    assert (ns > 0).any()


def _runs_case(host_lib, words, rnib, meta, XMAX, YMAX, slots, steps, rmax):
    """walk_runs<32, SLOTS> on the planes of a plain forward pass ==
    _walk_runs_plain on its directions: nruns and every run slot."""
    m9 = torch.from_numpy(np.ascontiguousarray(meta))
    x, y = ss._windows(torch.from_numpy(words), torch.from_numpy(rnib), m9,
                       XMAX, YMAX)
    xlen, ylen, band, xdrop = (m9[:, k] for k in (6, 3, 7, 8))
    L = 32 * slots
    _, mi, mj, _, dirs = ss._forward_plain(x, y, xlen, ylen, band, xdrop, L)
    want_n, want_runs = _walk_runs_plain(dirs, mi, mj, band, steps, rmax)
    planes = _planes(dirs.numpy(), 32, slots)
    n = len(meta)
    runs = np.zeros((n, rmax), np.int32)
    nruns = np.zeros(n, np.int32)
    arrs = [a.numpy().astype(np.int32) for a in (mi, mj, band)]
    rc = host_lib.thermite_swg_host_walk_runs(
        _ptr(planes), 32, slots, YMAX, *[_ptr(a) for a in arrs], n, steps,
        rmax,
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
            g = ss.stream_group(band, xmax)
            assert host_lib.thermite_swg_host_stream_group(
                band, xmax) == 100 * g[0] + g[1], (band, xmax)
            assert g[0] * g[1] >= ss.slots_needed(band, xmax)
            assert g in ss.STREAM_GROUPS
    # four problems a warp while 32 slots cover the launch, then two
    assert ss.stream_group(7, 96) == ss.stream_group(15, 96) == (8, 4)
    assert ss.stream_group(16, 96) == ss.stream_group(31, 96) == (16, 4)
    # 65..128 slots: one problem a warp timed faster than two (PERF.md)
    assert ss.stream_group(60, 96) == ss.stream_group(60, 512) == (32, 4)
    assert ss.stream_group(64, 512) == (32, 8)
    assert ss.stream_group(1023, 512) == (32, 32)
    assert ss.stream_group(40, 16) == (8, 4)


def test_shared_memory_fits_every_accepted_shape(host_lib):
    """Warps per block follow from the shared memory of a warp's
    problems, so every window the reference accepts (XMAX, YMAX <= 512,
    SMAX up to smax_for(512, 512)) launches within the 227 KB opt-in
    limit, for every group shape."""
    warps = np.zeros(1, np.int32)
    pw = smax_for(_WPAD, _WPAD) // 16
    for lanes, slots in ss.STREAM_GROUPS:
        for ymax in (32, 128, 160, 256, 512):
            words = host_lib.thermite_swg_host_smem(_WPAD, ymax, pw, lanes,
                                                    slots, 4, _ptr(warps))
            assert words == ss.problem_smem_words(_WPAD, ymax, pw, lanes, slots)
            assert words % 2 == 0 and 4 * words >= (
                (ymax + 1) * lanes * ss.dir_bytes(slots) + 4 * pw + _WPAD + ymax)
            assert 1 <= warps[0] <= 4
            assert warps[0] * (32 // lanes) * words * 4 <= 232448
    # the main path's shape: 16 problems a block in about 21 KB
    words = host_lib.thermite_swg_host_smem(96, 128, 13, 8, 4, 4, _ptr(warps))
    assert warps[0] == 4 and 16 * words * 4 < 24 * 1024
    # the direction planes alone at 32 x 32 slots, YMAX 512: one warp per block
    host_lib.thermite_swg_host_smem(_WPAD, _WPAD, pw, 32, 32, 4, _ptr(warps))
    assert warps[0] == 1
    # kernel 4 sizes a warp the same way, with its RMAX runs for pw
    for slots, ymax, rmax in ((1, 128, 24), (4, 160, 24), (32, 512, 64)):
        words = host_lib.thermite_swg_host_smem(96, ymax, rmax, 32, slots, 4,
                                                _ptr(warps))
        assert 4 * words == traceback_smem_bytes(96, ymax, rmax, slots)
    # the forward kernel holds the windows only
    assert host_lib.thermite_swg_host_smem(96, 160, 0, 0, 0, 4, _ptr(warps)) \
        == ss.problem_smem_words(96, 160, 0, 0, 0) == 66


def test_one_launch_covers_every_group_shape():
    """Both stream kernels are one source, one library and one launch:
    its dispatch instantiates exactly the shapes of STREAM_GROUPS (the
    table of csrc/swg_stream.cuh, in the same order), and the build table
    names a launch signature for each library and only sources that
    exist."""
    import re

    from thermite_tpu_torch.ops import _build

    with open(os.path.join(CSRC, "swg_stream.cu")) as f:
        src = f.read()
    assert src.count('extern "C"') == 1
    shapes = re.findall(r"launch_stream<(\d+), (\d+)>", src)
    assert [(int(a), int(b)) for a, b in shapes] == list(ss.STREAM_GROUPS)
    with open(os.path.join(CSRC, "swg_stream.cuh")) as f:
        table = re.search(r"table\[\] = \{(.*?)\};", f.read(), re.S).group(1)
    assert [(int(a), int(b)) for a, b in re.findall(r"\{(\d+),\s*(\d+)\}", table)] \
        == list(ss.STREAM_GROUPS)
    assert set(_build._LAUNCH) == set(_build.KERNELS)
    for name in (*_build.KERNELS.values(), *_build.HEADERS):
        assert os.path.exists(os.path.join(CSRC, name)), name
    assert "thermite_swg_stream_launch" in _build._LAUNCH["swg_stream"]
