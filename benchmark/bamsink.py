"""The file handle the program's BAM writer writes into during a run: it
counts the bytes and keeps only the BGZF blocks that the check reads.

The writer hands over whole BGZF blocks, one ``write`` each.  Each block
ends with its uncompressed size (ISIZE), so the sink knows the span of
the uncompressed BAM stream that every block covers, without
decompressing.  ``want(lo, hi)`` asks for the blocks that overlap the
uncompressed span [lo, hi) (a batch's records, asked for before the
writer sees them); every other block is counted and dropped, so a run
writes no file and keeps no stream.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple


class BlockSink:
    def __init__(self):
        self.bytes = 0  # compressed bytes written
        self.blocks = 0
        self.uoff = 0  # uncompressed bytes covered by the blocks so far
        self._want: List[Tuple[int, int]] = []
        self.kept: Dict[int, Tuple[int, int, bytes]] = {}  # block -> span, bytes

    def want(self, lo: int, hi: int) -> None:
        self._want.append((lo, hi))

    def write(self, block: bytes) -> int:
        n = len(block)
        isize = struct.unpack_from("<I", block, n - 4)[0]
        lo, hi = self.uoff, self.uoff + isize
        if any(a < hi and lo < b for a, b in self._want):
            self.kept[self.blocks] = (lo, hi, bytes(block))
        self.bytes += n
        self.blocks += 1
        self.uoff = hi
        return n

    def span(self, lo: int, hi: int) -> bytes:
        """The uncompressed bytes [lo, hi) from the kept blocks; raises
        ValueError when a kept block is malformed or the span is not
        covered."""
        out = bytearray()
        pos = lo
        for _, (ulo, uhi, block) in sorted(self.kept.items()):
            if uhi <= pos or ulo >= hi:
                continue
            data = inflate(block)
            if ulo + len(data) != uhi:
                raise ValueError("a BGZF block's size changed")
            if ulo > pos:
                raise ValueError(f"BAM bytes {pos}-{ulo} were not kept")
            out += data[pos - ulo : min(hi, uhi) - ulo]
            pos = min(hi, uhi)
            if pos >= hi:
                return bytes(out)
        raise ValueError(f"BAM bytes {pos}-{hi} were never written")


def inflate(block: bytes) -> bytes:
    """One BGZF block -> its uncompressed bytes, checked against its
    header, CRC32 and ISIZE."""
    if block[:4] != b"\x1f\x8b\x08\x04" or block[12:14] != b"BC":
        raise ValueError("not a BGZF block")
    bsize = struct.unpack_from("<H", block, 16)[0] + 1
    if bsize != len(block):
        raise ValueError(f"BGZF block of {len(block)} bytes says {bsize}")
    data = zlib.decompress(block[18:-8], -15)
    crc, isize = struct.unpack_from("<II", block, len(block) - 8)
    if isize != len(data) or crc != zlib.crc32(data):
        raise ValueError("BGZF block fails its CRC32 or ISIZE")
    return data


def split_records(data: bytes) -> List[bytes]:
    """BAM record blobs (each with its block_size prefix) of ``data``;
    raises ValueError when the last one runs past the end."""
    out = []
    pos = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ValueError("a BAM record's length runs past the batch")
        size = struct.unpack_from("<i", data, pos)[0]
        if size < 32 or pos + 4 + size > len(data):
            raise ValueError(f"a BAM record of {size} bytes runs past the batch")
        out.append(data[pos : pos + 4 + size])
        pos += 4 + size
    return out


def read_name(rec: bytes) -> bytes:
    """The read name of one BAM record blob."""
    n = rec[12]  # l_read_name, after block_size, refID, pos
    return rec[36 : 36 + n - 1]
