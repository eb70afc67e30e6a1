"""Helpers of the port's parity tests: the two packages side by side.

The port (``thermite_tpu_torch``) keeps its own copy of every host
class, so a reference object never equals a port object by ``==`` even
when every field agrees.  ``Both`` carries one object per package, built
from the same arguments; ``plain`` turns a result tree (dataclasses,
lists, lazy op views) into plain tuples and lists that compare across
packages."""

import dataclasses
from typing import NamedTuple

from thermite_tpu.align.driver import AlignOpts as RefAlignOpts
from thermite_tpu.index.build import Index as RefIndex
from thermite_tpu_torch.align.driver import AlignOpts as PortAlignOpts
from thermite_tpu_torch.index.build import Index as PortIndex


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
