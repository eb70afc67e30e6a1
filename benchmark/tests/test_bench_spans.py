"""The readers of the program's spans inside the chunk pipeline: a traced
run of the tiny cell on the CPU reports each of them, and what no span
covers is the window less the writer and less the program's top-level
spans, so that with them it adds up to the window."""

import time

import pytest

from benchmark import harness
from conftest import REPO

NEW = ("dispatch_s_per_mread", "unattributed_s_per_mread", "seed_s_per_mread",
       "build_cpu_s_per_mread", "cert_patch_s_per_mread", "emit_s_per_mread")


@pytest.fixture(scope="module")
def traced(tiny_root):
    """One traced run of the tiny cell, and the run record its readers
    were given."""
    runs = []
    reader = harness.metric_reader

    def keeping(root, name):
        read = reader(root, name)

        def kept(run):
            runs.append(run)
            return read(run)
        return kept

    harness.metric_reader = keeping
    try:
        out = harness.run_cell(tiny_root, "tiny.se90", 2**31 + 4242, 0.5,
                               True, time.time(), device="cpu")
    finally:
        harness.metric_reader = reader
    return out, runs[0]


@pytest.mark.parametrize("name", NEW)
def test_traced_run_reports_the_span_metrics(traced, name):
    out, run = traced
    assert out["correct"] is True
    assert out["metrics"][name]["unit"] == "s/Mread"
    assert out["metrics"][name]["value"] >= 0.0


def test_unattributed_is_the_window_less_the_spans(traced):
    out, run = traced
    st, per = run["stages"], 1e6 / run["reads"]
    top = [k for k in st if "/" not in k and not k.startswith("text ")]
    assert set(top) == {"prepare", "build", "dispatch", "arbitrate",
                        "finalize", "join"}
    got = out["metrics"]["unattributed_s_per_mread"]["value"]
    want = (run["window_s"] - run["bam_write_s"] - sum(st[k] for k in top)) * per
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    # with the writer and the top-level spans it is the whole window
    parts = (got + out["metrics"]["bam_write_s_per_mread"]["value"]
             + sum(st[k] for k in top) * per)
    assert parts == pytest.approx(run["window_s"] * per, rel=1e-12)
    assert out["metrics"]["dispatch_s_per_mread"]["value"] == \
        pytest.approx(st["dispatch"] * per, rel=1e-12)


def test_readers_of_a_program_without_the_spans():
    """Stage keys as a program without these spans records them: the
    readers find nothing and the result line leaves them out."""
    run = {"reads": 1000, "window_s": 2.0, "bam_write_s": 0.5,
           "stages": {"build": 0.5, "arbitrate": 0.2, "arbitrate/dsync": 0.1,
                      "finalize": 0.3, "finalize/dsync": 0.1}}
    for name in NEW:
        assert harness.metric_reader(REPO, name)(run) is None, name
    run["stages"].update({"dispatch": 0.1, "arbitrate/cpu": 0.2})
    read = harness.metric_reader(REPO, "unattributed_s_per_mread")
    assert read(run) == pytest.approx((2.0 - 0.5 - 1.1) * 1e3)
    assert harness.metric_reader(REPO, "cert_patch_s_per_mread")(run) == 0.0
