"""Build the hand-written kernels and the C++ host engine at first use.

Each CUDA kernel source (``csrc/*.cu``) is compiled by ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface and
loaded with ctypes; the sources are built in parallel, one ``nvcc`` each.
The libraries land in ``thermite_tpu_torch/_build/`` (listed in
``.gitignore``) under names keyed by a hash of the source, the shared
headers and the flags, so a changed source builds anew and an unchanged
one loads at once.  The host engine (``csrc/host/``) is built the same
way with g++.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# kernel library -> its source; every source includes both headers
# (swg_stream.cu holds both stream kernels)
KERNELS = {
    "swg_stream": "swg_stream.cu",
    "swg_forward": "swg_forward.cu",
    "swg_traceback": "swg_traceback.cu",
}
HEADERS = ("swg_stream.cuh", "swg_dp.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_p, _i64, _i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C signatures of each library's launch functions (csrc/*.cu, extern "C")
_LAUNCH = {
    "swg_stream": {"thermite_swg_stream_launch":
                   [_p, _i64, _p, _i64, _p, _i32, _i64, _i32, _i32, _i32,
                    _i32, _p, _p, _p]},
    "swg_forward": {"thermite_swg_forward_launch":
                    [_p, _i64, _p, _i64, _p, _i32, _i64, _i32, _i32, _i32,
                     _p, _p]},
    "swg_traceback": {
        "thermite_swg_traceback_launch":
            [_p, _i64, _p, _i64, _p, _i32, _i64, _i32, _i32, _i32, _i32,
             _p, _p, _p],
        "thermite_swg_traceback_dense_launch":
            [_p, _i64, _p, _i64, _p, _i64, _i32, _i32, _i32, _i32, _p, _p,
             _p],
    },
}

_kernel_libs: dict = {}
build_log: dict = {}  # library -> the compiler's report (ptxas registers/spills)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return nvcc


def _compile(cmd, out: str, what: str) -> str:
    """Run ``cmd`` writing ``out + '.tmp<pid>'``, then move it in place
    (a concurrent build never loads a half-written library); -> the
    compiler's stderr."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    r = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{what} build failed:\n{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, out)
    return r.stderr


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (KERNELS[name], *HEADERS):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_kernels() -> dict:
    """Compile every kernel library that is missing, all in parallel;
    -> {library: path}."""
    paths = {name: _lib_path(name) for name in KERNELS}
    todo = [name for name, path in paths.items() if not os.path.exists(path)]

    def one(name):
        cmd = [_nvcc(), *NVCC_FLAGS, os.path.join(CSRC, KERNELS[name])]
        build_log[name] = _compile(cmd, paths[name], f"CUDA kernel {name}")

    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            list(pool.map(one, todo))
    return paths


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (every library is built on the
    first call)."""
    if name not in _kernel_libs:
        lib = ctypes.CDLL(build_kernels()[name])
        for fn_name, argtypes in _LAUNCH[name].items():
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _kernel_libs[name] = lib
    return _kernel_libs[name]


HOST_CSRC = os.path.join(CSRC, "host")
_host_paths: dict = {}


def _host_lib(name: str, src: str, cmd: list) -> str:
    """Build ``csrc/host/<src>`` with ``cmd`` into ``_build/`` under a
    name keyed by a hash of the source and the command, unless it is
    there already; -> the library's path."""
    if name not in _host_paths:
        path = os.path.join(HOST_CSRC, src)
        h = hashlib.sha256(" ".join(cmd).encode())
        with open(path, "rb") as f:
            h.update(f.read())
        out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
        if not os.path.exists(out):
            build_log[name] = _compile(cmd + [path], out, name)
        _host_paths[name] = out
    return _host_paths[name]


def native_engine() -> str:
    """The C++ host engine (``csrc/host/thermite_native.cpp``: seeding,
    chunk build, arbitration, finalize, record emit), built with g++ at
    first use; -> the library's path.  A failed build raises."""
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-march=native", "-std=c++17",
           "-fPIC", "-pthread", "-shared"]
    return _host_lib("thermite_native", "thermite_native.cpp", cmd)


def object_builder() -> str:
    """The CPython-API result-object builder (``csrc/host/
    thermite_objbuild.c``), built with the C compiler against this
    interpreter's headers; -> the library's path.  It is optional: the
    caller (``align/objbuild.py``) builds the same objects in Python
    where this raises (no headers, no compiler)."""
    import sysconfig

    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"Python.h not found under {inc}")
    cmd = [os.environ.get("CC", "gcc"), "-O3", "-march=native", "-fPIC",
           f"-I{inc}", "-shared"]
    return _host_lib("thermite_objbuild", "thermite_objbuild.c", cmd)
