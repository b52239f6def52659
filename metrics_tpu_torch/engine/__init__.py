"""metrics_tpu_torch.engine: the multi-tenant fleet runtime (counterpart of ``metrics_tpu/engine``).

Layers:

* :mod:`metrics_tpu_torch.engine.core`: the shared batched-dispatch machinery (gather / stacked / masked
  ``torch.func.vmap`` modes, :class:`ProgramCache` LRUs with compile/hit/evict telemetry) that both the
  replica engine (``wrappers/replicated.py``) and the fleet engine build their programs through.
* :mod:`metrics_tpu_torch.engine.stream`: :class:`StreamEngine`: live ``Metric`` instances bucketed by
  ``(class, config, device, state avals)``, stacked into padded leading-axis tensors, and driven at one
  dispatch per tick with mid-stream session churn and no new program within padded capacity.
* :mod:`metrics_tpu_torch.engine.durability`: fleet crash recovery: incremental MTCKPT fleet checkpoints,
  the CRC-framed ingest WAL (:class:`IngestWAL`), and the checkpoint + journal replay behind
  ``StreamEngine.restore``; recovered fleets are bit-exact versus a never-crashed engine.
* :mod:`metrics_tpu_torch.engine.sharded`: :class:`ShardedStreamEngine`: the fleet partitioned across
  devices by stable session-id hash, one StreamEngine per shard with shard-local WAL + checkpoint files
  under a CRC-validated manifest, hierarchical cross-shard merge through the declared algebras, and the
  blast-radius ladder extended one rung (self-heal or demote a single shard).

``metrics_tpu_torch.engine.smoke`` holds the small churning fleet whose dispatch economics a baseline pins.
"""

from metrics_tpu_torch.engine.core import DispatchConsumedError, ProgramCache, engine_compute, engine_update
from metrics_tpu_torch.engine.durability import IngestWAL, replay_wal, restore_fleet_checkpoint, save_fleet_checkpoint
from metrics_tpu_torch.engine.sharded import ShardedStreamEngine
from metrics_tpu_torch.engine.stream import StreamEngine

__all__ = [
    "DispatchConsumedError",
    "IngestWAL",
    "ProgramCache",
    "ShardedStreamEngine",
    "StreamEngine",
    "engine_compute",
    "engine_update",
    "replay_wal",
    "restore_fleet_checkpoint",
    "save_fleet_checkpoint",
]
