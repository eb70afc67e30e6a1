"""BAM record encoding, from the SAM/BAM specification.

A frozen copy of the program's Python encoder (``io/bam.py``), which
writes the same bytes as its C++ emitter: the reference's records are
compared with the program's byte for byte.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from .sam import SamRecord


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
