"""Multi-host data parallelism: read sharding and output-shard merging.

The multi-host story for an embarrassingly read-parallel workload
(SURVEY §7 M5): every host loads the same index artifact, takes a
contiguous block of the input reads (``shard_bounds``), runs the batch
pipeline on its local chips, and writes its own output shard; the
shards are then merged **in host order**, which restores the original
input read order (block sharding is order-preserving).  No inter-host
communication is needed during alignment — cross-host collectives
(psum'd stats) ride the jit'd step in ``mesh.py``.

Merging is format-aware:
* SAM: first shard verbatim; later shards with their ``@`` header
  lines stripped.
* BAM: BGZF-level — the decompressed record bytes of later shards are
  appended verbatim after the first shard's header and re-blocked
  (byte-exact records, no decode/re-encode).
* PAF: plain concatenation.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

from ..io.bam import _BGZF_EOF, _bgzf_block, bam_header_len


def shard_bounds(n_reads: int, n_hosts: int, host_id: int) -> Tuple[int, int]:
    """Contiguous [start, end) block of reads owned by ``host_id``."""
    base = n_reads // n_hosts
    rem = n_reads % n_hosts
    start = host_id * base + min(host_id, rem)
    end = start + base + (1 if host_id < rem else 0)
    return start, end


def sniff_shard_format(path: str) -> str:
    """Detect a shard's format from its leading bytes: BGZF/gzip magic
    -> bam, an '@' header line -> sam, otherwise tab-separated -> paf."""
    with open(path, "rb") as f:
        head = f.read(4096)
    if head[:2] == b"\x1f\x8b":
        return "bam"
    if head[:1] == b"@":
        return "sam"
    first = head.split(b"\n", 1)[0]
    if first.count(b"\t") >= 11:  # PAF has >= 12 tab-separated fields
        return "paf"
    raise ValueError(
        f"cannot infer merge format from shard {path!r}; name the "
        "output with a .bam/.sam/.paf extension"
    )


def _read_bgzf_block(f) -> Optional[Tuple[bytes, int]]:
    """One raw BGZF block from ``f`` -> (compressed bytes, ISIZE), or
    None at end of file."""
    hdr = f.read(12)
    if not hdr:
        return None
    if len(hdr) < 12 or hdr[:4] != b"\x1f\x8b\x08\x04":
        raise ValueError("not a BGZF block (bad gzip/FEXTRA magic)")
    xlen = struct.unpack("<H", hdr[10:12])[0]
    extra = f.read(xlen)
    bsize = None
    off = 0
    while off + 4 <= xlen:
        si1, si2 = extra[off], extra[off + 1]
        slen = struct.unpack("<H", extra[off + 2 : off + 4])[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            bsize = struct.unpack("<H", extra[off + 4 : off + 6])[0] + 1
        off += 4 + slen
    if bsize is None:
        raise ValueError("BGZF block missing the BC size subfield")
    rest = f.read(bsize - 12 - xlen)
    raw = hdr + extra + rest
    if len(raw) != bsize:
        raise ValueError("truncated BGZF block")
    return raw, struct.unpack("<I", raw[-4:])[0]


def merge_shards(shard_paths: List[str], out_path: str, fmt: str) -> None:
    """Merge per-host output shards (in host order) into one file.

    BAM shards merge at the BGZF **block** level: compressed blocks are
    copied verbatim (records are never re-deflated); only the blocks
    overlapping a later shard's BAM header are inflated, trimmed past
    the header, and re-blocked.  Merge cost is therefore IO-bound
    (~bytes copied), not compression-bound — the serial merge tail no
    longer scales with shard size."""
    if fmt == "bam":
        with open(out_path, "wb") as fh:
            for i, p in enumerate(shard_paths):
                with open(p, "rb") as f:
                    try:
                        if i == 0:
                            # keep the header: raw-copy every non-empty
                            # block (empty blocks are EOF markers)
                            while (b := _read_bgzf_block(f)) is not None:
                                if b[1]:
                                    fh.write(b[0])
                            continue
                        buf = b""
                        hdr_len = None
                        while (b := _read_bgzf_block(f)) is not None:
                            raw, isize = b
                            if isize == 0:
                                continue
                            if hdr_len is not None:
                                fh.write(raw)  # past the header: splice
                                continue
                            buf += zlib.decompress(raw, 47)
                            try:
                                hdr_len = bam_header_len(buf)
                            except struct.error:
                                continue  # header spans more blocks
                            rem = buf[hdr_len:]
                            for o in range(0, len(rem), 60000):
                                fh.write(_bgzf_block(rem[o : o + 60000]))
                    except (ValueError, struct.error) as e:
                        raise ValueError(f"bad BAM shard {p!r}: {e}") from e
            fh.write(_BGZF_EOF)
        return
    if fmt == "sam":
        with open(out_path, "w") as out:
            for i, p in enumerate(shard_paths):
                with open(p) as f:
                    for line in f:
                        if i > 0 and line.startswith("@"):
                            continue
                        out.write(line)
        return
    if fmt == "paf":
        with open(out_path, "w") as out:
            for p in shard_paths:
                with open(p) as f:
                    out.write(f.read())
        return
    raise ValueError(f"unknown format {fmt!r}")
