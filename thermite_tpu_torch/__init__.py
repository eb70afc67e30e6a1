"""thermite-tpu-torch: the batch alignment path of ``thermite_tpu`` on
PyTorch and CUDA, for one NVIDIA Hopper GPU.

The port owns the device side: the hand-written CUDA stream kernel
(``ops/swg_stream.py``, ``csrc/swg_stream.cu``), the batch pipeline
(``align/batch.py``) and the entry points that build it (``align/run.py``,
``cli.py``).  Host stages are the reference's own, imported and not
copied: the C++ engine (seeding, task build, arbitration, finalize,
record emit), the index, the readers and writers.

Several of those reference host modules import the layout constants of
``thermite_tpu/ops/swg_pallas.py`` lazily, and that module imports JAX.
Where JAX is not installed, the JAX-free twin ``ops/layout.py`` is
registered under that module name before any reference host code runs,
so the lazy imports resolve to equal values.  Where JAX is installed,
nothing is registered and the reference module is used as it is.
"""

import importlib.util
import sys


def _jax_installed() -> bool:
    try:
        return importlib.util.find_spec("jax") is not None
    except (ImportError, ValueError):
        return False


if not _jax_installed() and "thermite_tpu.ops.swg_pallas" not in sys.modules:
    import thermite_tpu.ops  # noqa: F401  (parent package of the alias)

    from .ops import layout as _layout

    sys.modules["thermite_tpu.ops.swg_pallas"] = _layout
