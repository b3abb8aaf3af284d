"""The benchmark of ``ldpc_tpu_torch``: ``python3 -m ldpc_bench.run``
(``run.py``), the cells' files found by name (``cell.py``), the sampled
blocks recorded trial by trial (``record.py``) and judged against the plain
references that decide ``correct`` (``check.py``, ``reference/``), the
traced slice (``trace.py``), the kernels' counts
(``counts/``) and the per-layer metric readers (``metrics/``). It imports
neither ``jax`` nor the JAX package ``ldpc_tpu``."""
