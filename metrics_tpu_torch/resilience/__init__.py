"""Fault-tolerant metric runtime (counterpart of ``metrics_tpu/resilience``).

Three layers over the metric core:

- transactional updates live in ``metric.py`` itself (every update fully
  applies or leaves state untouched — this package only documents the contract);
- :mod:`metrics_tpu_torch.resilience.checkpoint` — crash-consistent atomic
  snapshots of any ``Metric`` or ``MetricCollection``, in the JAX package's
  container format, with versioned headers validated before a single byte of
  state is installed;
- :mod:`metrics_tpu_torch.resilience.guards` — opt-in NaN/Inf input policies
  (``propagate`` | ``skip_batch`` | ``raise_on_host``) that quarantine poisoned
  batches branch-free (``torch.where`` + a counter state, no host read except
  for ``raise_on_host``).

Degraded sync (retry/backoff + count-weighted partial merge of survivors) lives
in :mod:`metrics_tpu_torch.parallel.sync` next to the collectives it wraps.

The names are those of ``metrics_tpu.resilience.__all__``, in its order.
"""

from metrics_tpu_torch.resilience.checkpoint import (
    CheckpointError,
    CorruptCheckpointError,
    IncompatibleCheckpointError,
    PeriodicCheckpointer,
    SnapshotPolicy,
    restore_checkpoint,
    save_checkpoint,
)
from metrics_tpu_torch.resilience.guards import (
    GUARD_POLICIES,
    GUARD_STATE,
    PoisonedInputError,
    install_guard,
    poisoned_count,
)

__all__ = [
    "CheckpointError",
    "CorruptCheckpointError",
    "GUARD_POLICIES",
    "GUARD_STATE",
    "IncompatibleCheckpointError",
    "PeriodicCheckpointer",
    "PoisonedInputError",
    "SnapshotPolicy",
    "install_guard",
    "poisoned_count",
    "restore_checkpoint",
    "save_checkpoint",
]
