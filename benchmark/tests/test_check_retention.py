"""The check keeps a fixed number of batches, however many the window
runs: batch 0 and a reservoir drawn from the seed (``check.Retention``);
the sink gives up an evicted batch's blocks (``BlockSink.unwant``); a
tiny run keeps the same number at two window lengths and is correct, and
the control takes the same sample as a run of as many batches."""

import json
import struct
import time
import zlib

import numpy as np
import pytest

from benchmark import check, control, harness
from benchmark.bamsink import BlockSink

SEED = 2**33 + 18


@pytest.mark.parametrize("batches", [40, 400, 4000])
def test_keeps_a_fixed_number_of_batches(batches):
    ret = check.Retention(SEED)
    kept = set()
    for b in range(batches):
        keep, evicted = ret.offer(b)
        assert evicted is None or (keep and evicted in kept and evicted != 0)
        kept.discard(evicted)
        if keep:
            kept.add(b)
    assert len(kept) == check.RETAIN_BATCHES and 0 in kept
    assert sorted(kept) == sorted(ret.kept)
    assert check.kept_batches(SEED, batches) == sorted(kept)
    assert check.kept_batches(SEED + 1, batches) != sorted(kept)


def test_fewer_batches_than_places_are_all_kept():
    assert check.kept_batches(SEED, 5) == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        check.Retention(SEED).offer(1)


def test_every_eighth_of_the_window_is_picked_alike():
    """Over many seeds the reservoir's 7 places fall on each eighth of a
    400-batch window about equally often (batch 0 aside)."""
    counts = np.zeros(8)
    for seed in range(2000):
        for b in check.kept_batches(SEED + seed, 400)[1:]:
            counts[b * 8 // 400] += 1
    share = np.array([49] + [50] * 7) / 399  # batches 1-49, then 50 each
    want = share * 2000 * (check.RETAIN_BATCHES - 1)
    assert np.abs(counts / want - 1).max() < 0.1, counts


def _block(data: bytes) -> bytes:
    """One BGZF block of ``data``."""
    deflated = zlib.compress(data, 6)[2:-4]  # the raw deflate stream
    bsize = 18 + len(deflated) + 8
    head = b"\x1f\x8b\x08\x04\0\0\0\0\0\xff\x06\0BC\x02\0" \
        + struct.pack("<H", bsize - 1)
    return head + deflated + struct.pack("<II", zlib.crc32(data), len(data))


def test_unwant_drops_only_the_evicted_spans_blocks():
    stream = bytes(np.random.default_rng(1).integers(65, 70, 300,
                                                     dtype=np.uint8))
    spans = [(0, 100), (100, 200), (200, 300)]  # three batches
    sink = BlockSink()
    for s in spans:
        sink.want(*s)
    for lo in range(0, 300, 60):  # blocks 0-60, 60-120 (shared by 0 and 1)...
        sink.write(_block(stream[lo : lo + 60]))
    assert len(sink.kept) == 5
    sink.unwant(*spans[1])
    # 120-180 is batch 1's alone; 60-120 and 180-240 straddle a kept batch
    assert sorted(v[:2] for v in sink.kept.values()) == \
        [(0, 60), (60, 120), (180, 240), (240, 300)]
    assert sink.kept_bytes() == sum(len(v[2]) for v in sink.kept.values())
    for lo, hi in (spans[0], spans[2]):
        assert sink.span(lo, hi) == stream[lo:hi]
    with pytest.raises(ValueError):
        sink.span(*spans[1])
    sink.unwant(*spans[0])
    sink.unwant(*spans[2])
    assert sink.kept == {} and sink.kept_bytes() == 0


def _run_line(err: str) -> dict:
    line = [ln for ln in err.splitlines() if ln.startswith("run: ")][-1]
    return json.loads(line[len("run: "):])


@pytest.mark.parametrize("seconds", [3.0, 6.0])
def test_tiny_run_keeps_a_fixed_number(tiny_root, capsys, seconds):
    out = harness.run_cell(tiny_root, "tiny.se90", SEED, seconds, False,
                           time.time(), device="cpu")
    run = _run_line(capsys.readouterr().err)
    assert run["batches"] > check.RETAIN_BATCHES
    assert run["kept_batches"] == check.RETAIN_BATCHES
    assert run["kept_block_bytes"] > 0
    assert out["correct"] is True
    assert out["check"]["mismatched_reads"] == {"value": 0, "limit": 0}


def test_control_takes_the_runs_sample(tiny_root, capsys, monkeypatch):
    """``control_readings`` for a run's batch count judges the reads the
    run's check judged."""
    judged = []
    judge = check.judge

    def spy(got, reads, *args, **kw):
        judged.append(dict(reads))
        return judge(got, reads, *args, **kw)

    monkeypatch.setattr(check, "judge", spy)
    out = harness.run_cell(tiny_root, "tiny.se90", SEED + 3, 3.0, False,
                           time.time(), device="cpu")
    assert out["correct"] is True
    run = _run_line(capsys.readouterr().err)
    assert run["batches"] > check.RETAIN_BATCHES
    (ctl,) = control.control_readings(tiny_root, "tiny.se90", run["batches"],
                                      [SEED + 3])
    assert len(judged) == 2
    assert judged[0] == judged[1]
    assert ctl["checked_reads"] == len(judged[0]) == run["checked_reads"]
