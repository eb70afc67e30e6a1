"""Fixtures of the benchmark's tests: a throwaway checkout root that holds
a copy of the benchmark and one tiny cell, added as files and entries
only, which runs on the CPU.

Run them from the repository root: ``python -m pytest benchmark/tests -q``.
Tests marked ``card`` need a CUDA card and skip without one (decided
inside the test); on the card: ``python -m pytest benchmark/tests -m card``.
"""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_CFG = {"name": "tiny", "total_bp": 240_000, "n_chroms": 2,
            "genome_seed": 5, "gene_every": 22_000}
TINY_READS = 128


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


def add_tiny_cell(root: str, stride: int = 1,
                  gene_every: int = TINY_CFG["gene_every"]) -> str:
    """Add the config ``tiny``, the mix ``tiny`` and the cell ``tiny.se90``
    to the checkout at ``root`` as new files and entries; -> the cell."""
    bdir = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(bdir, "configs", "syn45.json")))
    cfg.update(TINY_CFG, seed_stride=stride, index="artifact",
               gene_every=gene_every)
    with open(os.path.join(bdir, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    tr = json.load(open(os.path.join(bdir, "traffic", "se90.json")))
    tr["batch_reads"] = TINY_READS
    with open(os.path.join(bdir, "traffic", "tiny.json"), "w") as f:
        json.dump(tr, f)
    spec_path = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(spec_path))
    spec["configs"].append({"name": "tiny", "source": "a tiny synthetic genome",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "tiny.se90", "config": "tiny",
                              "traffic": "tiny", "chips": 1, "why": "tests"})
    for m in spec["per_layer"]:
        m["workloads"].append("tiny.se90")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return "tiny.se90"


def copy_checkout(dst: str) -> str:
    """BENCHMARK.json and the benchmark's folder (without its caches and
    tests) under ``dst``; the program is imported from the repository."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "tests",
                                                  "__pycache__"))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout root with the tiny cell; its genome and artifact are
    built once for the session (in its own cache)."""
    import torch

    torch.set_num_threads(2)
    root = copy_checkout(str(tmp_path_factory.mktemp("root")))
    add_tiny_cell(root)
    return root


@pytest.fixture(scope="session")
def dense_root(tmp_path_factory):
    """A checkout root whose tiny cell has a gene every 1.5-2.5 kbp, so
    that about a tenth of its reads lie wholly in an exon and the
    transcriptome arbitration decides their records."""
    import torch

    torch.set_num_threads(2)
    root = copy_checkout(str(tmp_path_factory.mktemp("dense")))
    add_tiny_cell(root, gene_every=2_000)
    return root
