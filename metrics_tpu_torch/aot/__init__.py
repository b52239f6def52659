"""The kernel-library build cache behind the JAX package's AOT-cache names (counterpart of
``metrics_tpu/aot``).

The port persists no compiled program per metric class; what it builds and keeps across processes are the
kernel libraries of ``csrc/`` (``ops/_native.py``). :func:`cache_dir`/:func:`set_cache_dir` move their build
directory (``METRICS_TPU_TORCH_KERNEL_CACHE`` sets it for a new process), :func:`warm_registry` builds every
library, writes its validated manifest and runs one update of each profile case, and a later process
builds nothing. :func:`active` is False for every class; ``AotBinding`` has no counterpart (no update is
traced).
"""

from metrics_tpu_torch.aot.cache import (
    AOTCacheError,
    CorruptEntryError,
    ENV_VAR,
    StaleEntryError,
    cache_dir,
    cache_stats,
    entry_digest,
    entry_path,
    environment_fingerprint,
    purge_cache,
    set_cache_dir,
)
from metrics_tpu_torch.aot.runtime import active, call_signature

__all__ = [
    "AOTCacheError",
    "CorruptEntryError",
    "ENV_VAR",
    "StaleEntryError",
    "active",
    "cache_dir",
    "cache_stats",
    "call_signature",
    "entry_digest",
    "entry_path",
    "environment_fingerprint",
    "purge_cache",
    "set_cache_dir",
    "warm_registry",
]


def warm_registry(*args, **kwargs):
    """Lazy alias for :func:`metrics_tpu_torch.aot.warm.warm_registry` (it imports the metric registry)."""
    from metrics_tpu_torch.aot.warm import warm_registry as _warm

    return _warm(*args, **kwargs)
