"""What the port's tests of the benchmark's cells share: the benchmark's
tiny-cell helpers (``benchmark/tests/conftest.py``), a seed past 32 bits,
and a reader of BAM record blobs."""

import importlib.util
import os

from benchmark.bamsink import read_name, split_records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
SEED = 2**33 + 45


def _bench_conftest():
    """``benchmark/tests/conftest.py``: the tiny cell's genome and helpers."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_tests_conftest", os.path.join(BENCH, "tests", "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TINY = _bench_conftest()


def bam_fields(rec: bytes):
    """-> (flag, [(CIGAR op, length)], exonic) of one BAM record blob
    (``exonic``: the tag RE:A:E)."""
    n_name, n_cig = rec[12], int.from_bytes(rec[16:18], "little")
    flag = int.from_bytes(rec[18:20], "little")
    l_seq = int.from_bytes(rec[20:24], "little")
    at = 36 + n_name
    cig = [(b"MIDNSHP=X"[v & 15:(v & 15) + 1].decode(), v >> 4) for v in
           (int.from_bytes(rec[at + 4 * k : at + 4 * k + 4], "little")
            for k in range(n_cig))]
    tags = rec[at + 4 * n_cig + (l_seq + 1) // 2 + l_seq:]
    return flag, cig, b"REAE" in tags


def by_read(raw: bytes, names):
    """Each read's records (a list of blobs) in a batch's BAM record
    bytes, read by read in the order of ``names``."""
    recs = split_records(raw)
    out, p = [], 0
    for name in names:
        q = p
        while q < len(recs) and read_name(recs[q]) == name:
            q += 1
        assert q > p, name
        out.append(recs[p:q])
        p = q
    assert p == len(recs)
    return out
