"""The benchmark of the PyTorch and CUDA port, ``flypylib_tpu_torch``.

``run.py`` runs one cell of ``BENCHMARK.json``; the harness finds each
configuration, cell and per-layer metric by name in ``configs/``,
``workloads/`` and ``metrics/``.  Nothing here imports JAX or the JAX
package; ``reference.py`` imports nothing of the port either.
"""
