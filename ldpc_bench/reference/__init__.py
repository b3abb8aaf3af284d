"""Plain references that decide a run's ``correct``.

Plain PyTorch and NumPy, written for the benchmark and independent of the
code under test: nothing here imports ``ldpc_tpu_torch``, ``ldpc_tpu`` or
``jax``. Each decoder's reference is ``<decoder>.py``, found by the decoder
name in a configuration file; ``channel.py``, ``gf2.py`` and ``classify.py``
serve every decoder.

Every reference takes ``control``: the same computation one precision step
below the one the configuration states (the run's control, which has to
come out as not correct).
"""
