"""Framework exceptions (counterpart of ``metrics_tpu/utils/exceptions.py``)."""

from __future__ import annotations


class TPUMetricsUserError(Exception):
    """Error raised when user-facing API contracts are violated.

    The name is kept from the JAX package so that code catching it works with
    either package.
    """


class TPUMetricsUserWarning(UserWarning):
    """Warning for recoverable user-facing issues (the JAX package's name, kept for the same reason)."""


class TraceIneligibleError(RuntimeError):
    """A function refused to run under ``torch.func.vmap`` (data-dependent shapes or host math).

    Raised by the ``_is_traced`` guards where the JAX package raises its
    ``TraceIneligibleError``: class-count inference, data-dependent slicing,
    host-side group partitioning. The fleet engine treats it like a vmap
    refusal: the sessions of the wave run loose, as eager metrics.
    """
