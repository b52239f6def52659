"""Worker processes for the gloo case of ``tests/test_torch_engine_sharded.py`` (imports no JAX).

Each rank runs its own sharded fleet of MulticlassAccuracy sessions, fed from
a per-rank seed, and folds it with ``aggregate(template, mesh=True)``: the
cross-group stage all-reduces over the default gloo group. Every rank also
rebuilds every rank's batches into one oracle metric, and writes both to
``<out>/rank<r>.pt``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def _batches(rank: int):
    rng = np.random.RandomState(100 + rank)
    return [(f"r{rank}-s{i}", torch.from_numpy(rng.randint(4, size=8)), torch.from_numpy(rng.randint(4, size=8)))
            for i in range(6) for _ in range(2)]


def aggregate_worker(rank: int, world: int, init: str, out: str) -> None:
    from metrics_tpu_torch.classification import MulticlassAccuracy
    from metrics_tpu_torch.engine import ShardedStreamEngine

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        fleet = ShardedStreamEngine(n_shards=3, devices=["cpu"])
        for sid, preds, target in _batches(rank):
            if sid not in fleet.session_ids():
                fleet.add_session(MulticlassAccuracy(num_classes=4, device="cpu"), sid)
            fleet.submit(sid, preds, target)
        merged = fleet.aggregate(MulticlassAccuracy(num_classes=4, device="cpu"), mesh=True)
        oracle = MulticlassAccuracy(num_classes=4, device="cpu")
        count = 0
        for r in range(world):
            for _sid, preds, target in _batches(r):
                oracle.update(preds, target)
                count += 1
        empty = fleet.aggregate(MulticlassAccuracy(num_classes=7, device="cpu"), mesh=True)
        torch.save({"state": {k: v.clone() for k, v in merged._state.items()}, "count": merged._update_count,
                    "oracle": dict(oracle._state), "oracle_count": count, "empty_is_none": empty is None},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
