"""State sync across ranks over ``torch.distributed`` (counterpart of ``metrics_tpu/parallel``).

``shard_map_compat`` and ``build_mesh`` of the JAX package have no counterpart:
a ``torch.distributed`` process group takes the place of a mesh axis.
"""

from metrics_tpu_torch.parallel.sync import (
    SyncPeerLostError,
    SyncPolicy,
    allreduce_over_mesh,
    gather_all_states,
    get_sync_policy,
    pad_to_capacity,
    run_with_retries,
    seed_retry_jitter,
    set_sync_policy,
    sync_policy,
    sync_states,
)

__all__ = [
    "SyncPeerLostError",
    "SyncPolicy",
    "allreduce_over_mesh",
    "gather_all_states",
    "get_sync_policy",
    "pad_to_capacity",
    "run_with_retries",
    "seed_retry_jitter",
    "set_sync_policy",
    "sync_policy",
    "sync_states",
]
