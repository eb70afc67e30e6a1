"""On the card: a short run of each cell through the entry point gives a
result line that is correct, on the card, with every metric of the cell.
Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO

SPEC = json.load(open(os.path.join(REPO, "BENCHMARK.json")))


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 17), "--seconds", "3", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    group = SPEC["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in group if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    assert out.stderr.strip().splitlines()[-1].startswith("check mismatched_reads 0")


def test_no_card_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "syn45.se90",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
