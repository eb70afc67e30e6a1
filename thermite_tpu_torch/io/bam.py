"""BAM writing: BGZF container + binary record encoding.

Covers the capability the reference gets from the `noodles` bam writer
(reference src/aligner.rs:41-47); implemented from the SAM/BAM spec.
Also includes a minimal BAM *reader* used by the parity-metrics harness
(the reference test tooling uses pysam, which is not available here).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

from .sam import SamRecord, build_sam_header

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    # BSIZE = total block length - 1: header(18) + comp + crc(4) + isize(4) - 1
    bsize = len(comp) + 25
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<HHBBH", 6, 0x4342, 2, 0, bsize)
    )
    return header + comp + struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)


class BgzfWriter:
    def __init__(self, fh):
        self.fh = fh
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= 60000:
            self.fh.write(_bgzf_block(bytes(self.buf[:60000])))
            del self.buf[:60000]

    def finish(self) -> None:
        if self.buf:
            self.fh.write(_bgzf_block(bytes(self.buf)))
            self.buf.clear()
        self.fh.write(_BGZF_EOF)


_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
# byte translation tables for C-speed record encoding: base -> hex digit
# of its 4-bit code (unknown bases -> 'f' == N, matching the dict's
# default 15), and qual char -> clamped phred byte
_SEQ_HEX_TBL = bytes.maketrans(
    bytes(range(256)),
    bytes(
        ord("0123456789abcdef"[_SEQ_NIBBLE.get(chr(b), 15)])
        for b in range(256)
    ),
)
_QUAL_TBL = bytes.maketrans(
    bytes(range(256)),
    bytes(min(max(b - 33, 0), 93) for b in range(256)),
)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _parse_cigar(cigar: str) -> List[Tuple[int, int]]:
    """'10M2I' -> [(10, 0), (2, 1)] as (length, opcode)."""
    if cigar == "*":
        return []
    out = []
    n = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((n, _CIGAR_OPS.index(ch)))
            n = 0
    return out


def encode_bam_record(rec: SamRecord, ref_ids: dict) -> bytes:
    ref_id = ref_ids.get(rec.rname, -1)
    pos = rec.pos - 1  # 0-based; unmapped (pos=0) -> -1
    # l_read_name is a uint8 (incl. NUL): clamp like the C++ emitter
    name = rec.qname.encode()[:254] + b"\x00"
    cig = _parse_cigar(rec.cigar)
    seq = rec.seq if rec.seq != "*" else ""
    qual = rec.qual if rec.qual != "*" else ""
    l_seq = len(seq)
    ref_span = sum(n for n, op in cig if op in (0, 2, 3, 7, 8))
    bin_ = _reg2bin(pos, pos + ref_span) if pos >= 0 else _reg2bin(-1, 0)

    body = bytearray()
    if rec.rnext == "*":
        next_ref = -1
    elif rec.rnext == "=":  # SAM shorthand: mate on this record's ref
        next_ref = ref_id
    else:
        next_ref = ref_ids.get(rec.rnext, -1)
    body += struct.pack(
        "<iiBBHHHiiii",
        ref_id,
        pos,
        len(name),
        rec.mapq,
        bin_,
        len(cig),
        rec.flag,
        l_seq,
        next_ref,
        rec.pnext - 1,
        rec.tlen,
    )
    body += name
    for n, op in cig:
        body += struct.pack("<I", (n << 4) | op)
    if l_seq:
        # C-speed nibble packing: translate bases to hex digits of
        # their 4-bit codes, then bytes.fromhex packs pairs
        hexs = seq.encode().translate(_SEQ_HEX_TBL).decode()
        if l_seq & 1:
            hexs += "0"
        body += bytes.fromhex(hexs)
    if qual and len(qual) == l_seq:
        body += qual.encode().translate(_QUAL_TBL)
    else:
        body += b"\xff" * l_seq
    for tag, ty, val in rec.tags:
        body += tag.encode()
        if ty == "i":
            body += b"i" + struct.pack("<i", int(val))
        elif ty == "Z":
            body += b"Z" + val.encode() + b"\x00"
        elif ty == "A":
            body += b"A" + val.encode()
        elif ty == "f":
            body += b"f" + struct.pack("<f", float(val))
        else:  # pragma: no cover
            raise ValueError(f"unsupported tag type {ty}")
    return struct.pack("<i", len(body)) + bytes(body)


class BamWriter:
    def __init__(self, fh, index):
        from .sam import unique_refs

        self.bgzf = BgzfWriter(fh)
        header_text = build_sam_header(index)
        refs = unique_refs(index)
        self.ref_ids = {name: i for i, (name, _) in enumerate(refs)}
        blob = bytearray(b"BAM\x01")
        ht = header_text.encode()
        blob += struct.pack("<i", len(ht)) + ht
        blob += struct.pack("<i", len(refs))
        for name, ln in refs:
            nb = name.encode() + b"\x00"
            blob += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self.bgzf.write(bytes(blob))

    def write(self, rec: SamRecord) -> None:
        self.bgzf.write(encode_bam_record(rec, self.ref_ids))

    def write_raw(self, data: bytes) -> None:
        """Append pre-encoded BAM record blobs (C++ emitter output)."""
        self.bgzf.write(data)

    def finish(self) -> None:
        self.bgzf.finish()


# ---------------------------------------------------------------------------
# Minimal BAM reader (for the metrics harness and tests).


@dataclass
class BamRead:
    qname: str
    flag: int
    rname: Optional[str]
    pos: int  # 0-based
    mapq: int
    cigar: List[Tuple[int, int]]  # (len, opcode)
    seq: str
    qual: str
    tags: dict = field(default_factory=dict)
    # mate fields (paired-end; 0 defaults preserve old call sites)
    next_ref_id: int = -1
    next_pos: int = -1  # 0-based
    tlen: int = 0

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 4)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & 256)

    @property
    def reference_end(self) -> int:
        return self.pos + sum(n for n, op in self.cigar if op in (0, 2, 3, 7, 8))

    @property
    def query_alignment_length(self) -> int:
        return sum(n for n, op in self.cigar if op in (0, 1, 7, 8))

    @property
    def reference_length(self) -> int:
        return sum(n for n, op in self.cigar if op in (0, 2, 3, 7, 8))

    def cigar_string(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{n}{_CIGAR_OPS[op]}" for n, op in self.cigar)


def bam_header_len(data: bytes) -> int:
    """Byte length of the uncompressed BAM header (magic..refs).
    Raises struct.error on a truncated buffer (callers may retry with
    more bytes) and AssertionError on a non-BAM stream."""
    if len(data) < 4:
        # truncated, not provably non-BAM: let callers retry/report
        raise struct.error("truncated BAM stream (< 4 bytes)")
    assert data[:4] == b"BAM\x01", "not a BAM stream"
    (l_text,) = struct.unpack("<i", data[4:8])
    off = 8 + l_text
    (n_ref,) = struct.unpack("<i", data[off : off + 4])
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", data[off : off + 4])
        off += 4 + l_name + 4
    return off


def read_bam(path: str) -> Tuple[str, List[str], Iterator[BamRead]]:
    """Returns (header_text, ref_names, record iterator)."""
    import gzip

    data = gzip.open(path, "rb").read()
    off = 0

    def take(n):
        nonlocal off
        b = data[off : off + n]
        off += n
        return b

    magic = take(4)
    assert magic == b"BAM\x01", "not a BAM file"
    (l_text,) = struct.unpack("<i", take(4))
    header_text = take(l_text).decode()
    (n_ref,) = struct.unpack("<i", take(4))
    ref_names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", take(4))
        ref_names.append(take(l_name)[:-1].decode())
        take(4)

    def records():
        nonlocal off
        rev_bases = "=ACMGRSVTWYHKDBN"
        while off < len(data):
            (block_size,) = struct.unpack("<i", data[off : off + 4])
            body = data[off + 4 : off + 4 + block_size]
            off += 4 + block_size
            (
                ref_id,
                pos,
                l_name,
                mapq,
                _bin,
                n_cig,
                flag,
                l_seq,
                nref,
                npos,
                tlen,
            ) = struct.unpack("<iiBBHHHiiii", body[:32])
            p = 32
            qname = body[p : p + l_name - 1].decode()
            p += l_name
            cig = []
            for _ in range(n_cig):
                (v,) = struct.unpack("<I", body[p : p + 4])
                cig.append((v >> 4, v & 0xF))
                p += 4
            seq_chars = []
            for i in range(l_seq):
                byte = body[p + i // 2]
                nib = (byte >> 4) if i % 2 == 0 else (byte & 0xF)
                seq_chars.append(rev_bases[nib])
            p += (l_seq + 1) // 2
            qual = "".join(
                chr(q + 33) if q != 0xFF else "*" for q in body[p : p + l_seq]
            )
            p += l_seq
            tags = {}
            while p < len(body):
                tag = body[p : p + 2].decode()
                ty = chr(body[p + 2])
                p += 3
                if ty == "i":
                    (v,) = struct.unpack("<i", body[p : p + 4])
                    p += 4
                elif ty in "cC":
                    v = body[p]
                    if ty == "c" and v > 127:
                        v -= 256
                    p += 1
                elif ty in "sS":
                    (v,) = struct.unpack("<h" if ty == "s" else "<H", body[p : p + 2])
                    p += 2
                elif ty == "I":
                    (v,) = struct.unpack("<I", body[p : p + 4])
                    p += 4
                elif ty == "f":
                    (v,) = struct.unpack("<f", body[p : p + 4])
                    p += 4
                elif ty == "A":
                    v = chr(body[p])
                    p += 1
                elif ty == "Z":
                    end = body.index(0, p)
                    v = body[p:end].decode()
                    p = end + 1
                elif ty == "B":
                    sub = chr(body[p])
                    (cnt,) = struct.unpack("<i", body[p + 1 : p + 5])
                    sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
                    v = body[p + 5 : p + 5 + cnt * sz]
                    p += 5 + cnt * sz
                else:  # pragma: no cover
                    raise ValueError(f"unknown tag type {ty}")
                tags[tag] = v
            yield BamRead(
                qname=qname,
                flag=flag,
                rname=ref_names[ref_id] if ref_id >= 0 else None,
                pos=pos,
                mapq=mapq,
                cigar=cig,
                seq="".join(seq_chars) if l_seq else "*",
                qual=qual if l_seq else "*",
                tags=tags,
                next_ref_id=nref,
                next_pos=npos,
                tlen=tlen,
            )

    return header_text, ref_names, records()
