"""The harness finds cells, configurations, mixes and metrics by name;
a cell added as files and entries only is found and runs; a run of the
tiny cell on the CPU is correct, a run with its timed path broken is
not, and neither is a run with the control in the program's place."""

import json
import os
import time

import pytest

from benchmark import harness
from conftest import REPO, add_tiny_cell, copy_checkout


def _spec():
    return json.load(open(os.path.join(REPO, "BENCHMARK.json")))


@pytest.mark.parametrize("workload", [w["name"] for w in _spec()["workloads"]])
def test_every_cell_resolves(workload):
    spec, cell, cfg, traffic = harness.find_cell(REPO, workload)
    assert cfg["name"] == cell["config"]
    assert harness.generator(REPO, traffic["generator"]).make_batch
    for trace in (False, True):
        for m in harness.cell_metrics(spec, workload, trace):
            assert callable(harness.metric_reader(REPO, m["name"]))


def test_unknown_workload_is_refused():
    with pytest.raises(harness.CellError):
        harness.find_cell(REPO, "no.such.cell")


def test_cell_added_as_files_only(tmp_path):
    root = copy_checkout(str(tmp_path))
    before = {p: open(os.path.join(root, "benchmark", p), "rb").read()
              for p in ("harness.py", "run.py", "check.py", "trace.py")}
    cell = add_tiny_cell(root)
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "metrics", "tiny_reads.py"), "w") as f:
        f.write("def read(run):\n    return run['reads']\n")
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["per_layer"].append({"name": "tiny_reads", "unit": "reads",
                              "better": "higher", "source": "host_clock",
                              "layer": "bench", "moves": "reads_per_s",
                              "workloads": [cell]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    spec, c, cfg, traffic = harness.find_cell(root, cell)
    assert (c["config"], cfg["total_bp"], traffic["batch_reads"]) == \
        ("tiny", 240_000, 128)
    names = [m["name"] for m in harness.cell_metrics(spec, cell, True)]
    assert "tiny_reads" in names
    assert harness.metric_reader(root, "tiny_reads")({"reads": 7}) == 7
    # the existing cells do not report the new metric
    assert "tiny_reads" not in [m["name"] for m in harness.cell_metrics(
        spec, "syn45.se90", True)]
    for p, b in before.items():
        assert open(os.path.join(bdir, p), "rb").read() == b


def _run(root, trace=False, run_batch=None, seed=2**31 + 99):
    return harness.run_cell(root, "tiny.se90", seed, 0.5, trace, time.time(),
                            device="cpu", run_batch=run_batch)


def test_tiny_run_is_correct(tiny_root):
    out = _run(tiny_root, trace=True)
    assert out["correct"] is True
    assert out["failed"] == 0
    assert list(out)[-1] == "check"
    assert out["check"]["mismatched_reads"] == {"value": 0, "limit": 0}
    got = set(out["metrics"])
    want = {m["name"] for m in harness.cell_metrics(
        harness.find_cell(tiny_root, "tiny.se90")[0], "tiny.se90", True)}
    # the CPU has no device trace: the roofline reader finds nothing
    assert got == want - {"swg_stream_roofline"}
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    plain = _run(tiny_root)
    assert set(plain["metrics"]) == {"reads_per_s", "host_peak_gib", "setup_s"}
    assert plain["correct"] is True


def _half(aligner, recs):
    """Half of the batch left out: only the first half is aligned."""
    return aligner.align_batch_emit(recs[: len(recs) // 2], True)


def _altered(aligner, recs):
    """An answer altered where it is produced: every eighth record's
    position moves by one."""
    import struct

    raw = bytearray(aligner.align_batch_emit(recs, True))
    pos = n = 0
    while pos < len(raw):
        size = struct.unpack_from("<i", raw, pos)[0]
        if n % 8 == 0:
            p = struct.unpack_from("<i", raw, pos + 8)[0]
            struct.pack_into("<i", raw, pos + 8, p + 1)
        pos += 4 + size
        n += 1
    return bytes(raw)


def _stale():
    """A step that returns its state unchanged: every batch gets the
    records of the first batch the aligner saw."""
    first = []

    def run(aligner, recs):
        if not first:
            first.append(aligner.align_batch_emit(recs, True))
        return first[0]
    return run


@pytest.mark.parametrize("fault", ["half", "altered", "stale"])
def test_broken_timed_path_is_not_correct(tiny_root, fault):
    run_batch = {"half": _half, "altered": _altered, "stale": _stale()}[fault]
    out = _run(tiny_root, run_batch=run_batch)
    assert out["correct"] is False
    assert out["check"]["mismatched_reads"]["value"] > 0


def _reference_in_place(root, make):
    """The reference made by ``make`` (the plain one or the control) put
    in the program's place: a batch's records are its records."""
    from benchmark.reference.genome import Genome

    cfg = harness.find_cell(root, "tiny.se90")[2]
    genome = harness.ensure_caches(root, cfg)
    ref_genome = Genome.from_files(genome["fasta"], genome["gtf"])

    def run(aligner, recs):
        ref = make(ref_genome, cfg, [r[1] for r in recs])
        return b"".join(ref.records(*r) for r in recs)
    return run


@pytest.mark.parametrize("side", ["program", "reference", "control"])
def test_control_in_place_is_not_correct(dense_root, side):
    """The control goes through ``run_cell``'s own ``correct``: on a
    genome dense with genes it fails where the program and the plain
    reference in the same place pass."""
    from benchmark import check
    from benchmark.reference import Reference

    run_batch = None if side == "program" else _reference_in_place(
        dense_root, {"reference": Reference,
                     "control": check.control_reference}[side])
    out = _run(dense_root, run_batch=run_batch, seed=2**32 + 7)
    assert out["correct"] is (side != "control")
    bad = out["check"]["mismatched_reads"]["value"]
    assert (bad > 0) is (side == "control")
