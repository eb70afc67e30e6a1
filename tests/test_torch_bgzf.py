"""The port's BGZF writer (``io/bam.py::BgzfWriter``) on the CPU.

A write of two or more full blocks compresses them on a thread pool of
``THERMITE_THREADS`` threads.  The bytes equal a serial loop over
``_bgzf_block`` and the reference's writer at every thread count and
write pattern.  What the benchmark's sink and harness rely on holds:
each block reaches the handle as one ``write``, in stream order, before
the call returns; ``buf`` keeps exactly the tail; a header alone writes
no block."""

import random
import struct
from types import SimpleNamespace

import pytest

from benchmark.bamsink import BlockSink, inflate
from thermite_tpu.io.bam import BgzfWriter as RefBgzfWriter
from thermite_tpu_torch.io import bam
from thermite_tpu_torch.io.bam import BamWriter, BgzfWriter, _bgzf_block

BLOCK = 60000


def _stream(n: int, seed: int = 7) -> bytes:
    """BAM-like bytes: runs of a few symbols, so deflate has work."""
    rng = random.Random(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([rng.choice(b"ACGTI\x00\x01\x5a")]) * rng.randint(1, 12)
    return bytes(out[:n])


STREAM = _stream(420_000)

# write sizes, in order, over STREAM
CASES = {
    "0": [0],
    "1": [1],
    "59999": [59999],
    "60000": [60000],
    "60001": [60001],
    "2x60000": [2 * 60000],
    "3x60000+17": [3 * 60000 + 17],
    "small_writes_across_edges": [997] * 400,
    "write_on_a_partial_tail": [1234, 3 * 60000 + 17, 59999, 2 * 60000 + 1],
}


class Handle:
    """A file handle that keeps each ``write`` apart."""

    def __init__(self):
        self.writes = []

    def write(self, b) -> int:
        self.writes.append(bytes(b))
        return len(b)


def _serial(data: bytes) -> bytes:
    out = b"".join(_bgzf_block(data[o : o + BLOCK])
                   for o in range(0, len(data), BLOCK))
    return out + bam._BGZF_EOF


def _writes(sizes):
    pos = 0
    for n in sizes:
        yield STREAM[pos : pos + n]
        pos += n


@pytest.mark.parametrize("threads", [1, 2, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pooled_bytes_equal_serial_and_reference(case, threads, monkeypatch):
    monkeypatch.setenv("THERMITE_THREADS", str(threads))
    port, ref = Handle(), Handle()
    pw, rw = BgzfWriter(port), RefBgzfWriter(ref)
    pooled = False
    for data in _writes(CASES[case]):
        pooled |= (len(pw.buf) + len(data)) // BLOCK > 1
        pw.write(data)
        rw.write(data)
    pw.finish()
    rw.finish()
    written = b"".join(port.writes)
    assert written == b"".join(ref.writes)
    assert written == _serial(STREAM[: sum(CASES[case])])
    if pooled and threads > 1:  # the pool took the count set now
        assert bam._pool_threads == threads


@pytest.mark.parametrize("threads", [1, 4])
def test_write_contract_of_the_sink_and_harness(threads, monkeypatch):
    monkeypatch.setenv("THERMITE_THREADS", str(threads))
    index = SimpleNamespace(refs=[SimpleNamespace(name="chr1", len=45_000_000),
                                  SimpleNamespace(name="chr1", len=45_000_000)])
    # a header alone writes no block: the harness's ``head`` check
    fh = Handle()
    writer = BamWriter(fh, index)
    assert fh.writes == []
    head = len(writer.bgzf.buf)
    assert bytes(writer.bgzf.buf[:4]) == b"BAM\x01"
    assert head == bam.bam_header_len(bytes(writer.bgzf.buf))

    stream = bytes(writer.bgzf.buf)
    sizes = [3 * BLOCK + 17, 5, 2 * BLOCK - 22, BLOCK + 1]
    for data in _writes(sizes):
        writer.write_raw(data)
        stream += data
        # every full block reached the handle before the call returned,
        # one write each, in stream order; the buffer holds the tail
        assert len(fh.writes) == len(stream) // BLOCK
        assert [inflate(b) for b in fh.writes] == [
            stream[o : o + BLOCK] for o in range(0, len(fh.writes) * BLOCK, BLOCK)]
        isize = sum(struct.unpack_from("<I", b, len(b) - 4)[0] for b in fh.writes)
        assert isize == len(stream) - len(writer.bgzf.buf)
        assert type(writer.bgzf.buf) is bytearray
        assert writer.bgzf.buf == stream[len(stream) - len(stream) % BLOCK :]
    writer.finish()
    assert b"".join(fh.writes) == _serial(stream)

    # a real sink over a three-batch write gives back the stream
    sink = BlockSink()
    writer = BamWriter(sink, index)
    assert sink.blocks == 0
    sink.want(0, head)
    uoff = head
    batches = list(_writes([150_001, 122_222, 99_999]))
    spans = []
    for i, raw in enumerate(batches):
        if i != 1:
            sink.want(uoff, uoff + len(raw))
        spans.append((uoff, uoff + len(raw)))
        writer.write_raw(raw)
        uoff += len(raw)
        assert sink.uoff == uoff - len(writer.bgzf.buf)
    assert sink.blocks == uoff // BLOCK
    writer.finish()
    assert sink.span(0, head) == stream[:head]
    for i in (0, 2):
        assert sink.span(*spans[i]) == batches[i]
