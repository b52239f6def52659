"""Framework exceptions (counterpart of ``metrics_tpu/utils/exceptions.py``)."""

from __future__ import annotations


class TPUMetricsUserError(Exception):
    """Error raised when user-facing API contracts are violated.

    The name is kept from the JAX package so that code catching it works with
    either package.
    """


class TPUMetricsUserWarning(UserWarning):
    """Warning for recoverable user-facing issues (the JAX package's name, kept for the same reason)."""
