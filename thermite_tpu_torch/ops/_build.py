"""Build the hand-written kernels and the reference's C++ engine at first
use.

The CUDA kernel (``csrc/swg_stream.cu``) is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ctypes.  The library lands in ``thermite_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name keyed by a hash of the sources and flags,
so a changed source builds anew and an unchanged one loads at once.  A
failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNEL_SOURCES = ("swg_stream.cu", "swg_stream.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_kernel_lib = None
build_log = ""  # the compiler's report (ptxas registers/spills) of the last build


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
    (a concurrent build never loads a half-written library)."""
    global build_log
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    r = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{what} build failed:\n{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, out)
    build_log = r.stderr
    return out


def build_kernels() -> str:
    """Compile the CUDA kernel library if needed; -> its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in KERNEL_SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libswg_stream_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    cmd = [_nvcc(), *NVCC_FLAGS, os.path.join(CSRC, "swg_stream.cu")]
    return _compile(cmd, out, "CUDA kernel")


def kernel_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _kernel_lib
    if _kernel_lib is None:
        lib = ctypes.CDLL(build_kernels())
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn = lib.thermite_swg_stream_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [p, i64, p, i64, p, i32, i64, i32, i32, i32, p, p, p]
        _kernel_lib = lib
    return _kernel_lib


def native_engine() -> None:
    """Build the reference's C++ host engine (``thermite_tpu/seed/
    _native.so``, gitignored) with g++ when a fresh checkout lacks it.
    The reference builds it through ``make -C csrc`` together with an
    optional CPython-API object builder; building the engine alone here
    keeps the alignment path independent of that optional part."""
    from thermite_tpu.seed import native

    if os.path.exists(native._LIB_PATH):
        return
    src = os.path.join(os.path.dirname(_PKG), "csrc", "thermite_native.cpp")
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-march=native", "-std=c++17",
           "-fPIC", "-pthread", "-shared", src]
    _compile(cmd, native._LIB_PATH, "C++ engine")
