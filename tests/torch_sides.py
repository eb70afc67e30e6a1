"""Helpers of the port's parity tests: the two packages side by side.

The port (``thermite_tpu_torch``) keeps its own copy of every host
class, so a reference object never equals a port object by ``==`` even
when every field agrees.  ``Both`` carries one object per package, built
from the same arguments; ``plain`` turns a result tree (dataclasses,
lists, lazy op views) into plain tuples and lists that compare across
packages.

Importing this module also makes sure the reference's C++ libraries
are built and load (``build_reference_engine``)."""

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import subprocess
import tempfile
from typing import NamedTuple

import thermite_tpu.align.objbuild as ref_objbuild
import thermite_tpu.seed.native as ref_native
from thermite_tpu.align.driver import AlignOpts as RefAlignOpts
from thermite_tpu.index.build import Index as RefIndex
from thermite_tpu_torch.align.driver import AlignOpts as PortAlignOpts
from thermite_tpu_torch.index.build import Index as PortIndex

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
    except OSError:
        return False
    return True


def build_reference_engine() -> None:
    """Build the reference's ``_native.so`` and ``_objbuild.so`` under an
    exclusive lock, and reset its loaders where a racing build failed.

    The reference builds them at first use with ``make -C csrc``, which
    links straight onto the target path: test processes that start
    together race, a loser loads a half-written library, and the
    reference then remembers the failure for the life of the process.
    Here every process takes one lock (outside the repository), runs
    make, and loads each library; one that does not load is removed and
    built again under the same lock."""
    libs = (ref_native._LIB_PATH, ref_objbuild._LIB_PATH)
    tag = hashlib.sha1(os.path.realpath(CSRC).encode()).hexdigest()[:12]
    lock = os.path.join(tempfile.gettempdir(), f"thermite_csrc_{tag}.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            for _ in range(2):
                subprocess.run(["make", "-C", CSRC], check=True,
                               capture_output=True, timeout=600)
                bad = [p for p in libs if not _loads(p)]
                for p in bad:
                    os.remove(p)
                if not bad:
                    break
            else:
                raise RuntimeError(f"{bad} do not load after a rebuild")
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    if ref_native._load_failed:
        ref_native._lib, ref_native._load_failed = None, False
    if ref_objbuild._state == "failed":
        ref_objbuild._lib, ref_objbuild._state = None, "unloaded"


build_reference_engine()


class Both(NamedTuple):
    ref: object
    port: object


def indexes(fasta, gtf) -> Both:
    """The reference's and the port's ``Index`` of the same FASTA/GTF."""
    return Both(RefIndex.create_from_files(fasta, gtf),
                PortIndex.create_from_files(fasta, gtf))


def align_opts(**kw) -> Both:
    return Both(RefAlignOpts(**kw), PortAlignOpts(**kw))


def plain(obj):
    """A result tree as tuples (dataclasses: the fields that take part
    in equality), lists and scalars."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return tuple(plain(getattr(obj, f.name))
                     for f in dataclasses.fields(obj) if f.compare)
    if isinstance(obj, (str, bytes)):
        return obj
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if hasattr(obj, "__iter__"):
        return [plain(v) for v in obj]
    return obj
