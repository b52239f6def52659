"""The benchmark's own library: cells and files found by name, traffic, statistics, traces and rooflines.

Nothing here imports the program (``metrics_tpu_torch``) at module level, and nothing
imports ``jax`` or the JAX package ``metrics_tpu``.
"""
