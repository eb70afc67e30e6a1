"""Nothing the benchmark runs imports JAX or the JAX package: a static
look at every import of every source under ``benchmark/``, and a process
that imports every module the harness runs, the program's with them,
then reads ``sys.modules`` by whole top-level name (``thermite_tpu_torch``
begins with ``thermite_tpu`` and is neither)."""

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness
from conftest import REPO

BENCH = os.path.join(REPO, "benchmark")
SOURCES = sorted(p for p in glob.glob(os.path.join(BENCH, "**", "*.py"),
                                      recursive=True)
                 if "/.cache/" not in p)


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    assert len(SOURCES) > 20
    for path in SOURCES:
        bad = set(_top_names(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "thermite_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.x", sys)
    assert not (set(harness.forbidden_modules()) - {"jax", "jaxlib"})
    monkeypatch.setitem(sys.modules, "thermite_tpu.fake", sys)
    assert "thermite_tpu" in harness.forbidden_modules()


def test_a_process_that_loads_the_harness_loads_no_jax():
    mods = ["benchmark." + os.path.relpath(p, BENCH)[:-3].replace("/", ".")
            for p in SOURCES if "/tests/" not in p and "/metrics/" not in p
            and not p.endswith("__init__.py")]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import thermite_tpu_torch.align.batch, thermite_tpu_torch.io.bam\n"
        "import thermite_tpu_torch.parallel.mesh, torch.profiler\n"
        "from benchmark.harness import forbidden_modules\n"
        "print(sorted(forbidden_modules()))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
