"""thermite-tpu-torch: the spliced short-read aligner ``thermite_tpu`` on
PyTorch and CUDA, for one NVIDIA Hopper GPU.

The package is self-contained: it imports ``torch``, numpy and the
standard library, and nothing of the JAX reference package.  It owns the
device side (the hand-written CUDA kernels under ``csrc/`` and their
wrappers in ``ops/``, the batch pipeline ``align/batch.py``) and its own
copy of every host stage: the index (``index/``), the readers and
writers (``io/``), seeding (``seed/``), the sequential oracle
(``align/driver.py``, ``ops/swg_ref.py``), pairing, shards and merge,
and the C++ host engine (``csrc/host/``, built with g++ into ``_build/``
at first use).  Artifacts (``.tai.npz``) and output shards are
interchangeable with the reference package's.
"""
