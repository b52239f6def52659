"""Faults planted under the timed path, each of which a run must report as not correct, and a module the
benchmark must never load, planted on one rank."""

import sys
import types

import torch.distributed as dist


def state_unchanged(collection):
    """Every update returns with the state as it was."""
    for m in collection.values():
        object.__setattr__(m, "update", lambda *args, **kwargs: None)
    return collection


def half_batch(collection):
    """Each update folds the first half of its rows only: the means are taken over the rest."""
    orig = collection.update

    def update(*args, **kwargs):
        orig(*[a[: a.shape[0] // 2] for a in args], **kwargs)

    collection.update = update
    return collection


def answer_altered(collection):
    """The first value of every compute is moved by one part in ten thousand where it is produced."""
    orig = collection.compute

    def compute():
        out = dict(orig())
        key = sorted(out)[0]
        out[key] = out[key] * (1 + 1e-4)
        return out

    collection.compute = compute
    return collection


def _local_only(states, group):
    return [[s] for s in states]


def exchange_left_out(collection):
    """Each rank computes over its own rows: the gather between ranks is left out."""
    for m in collection.values():
        m.dist_sync_fn = _local_only
    return collection


def jax_on_rank_1(collection):
    """Rank 1's process loads a module named ``jax`` (a stand-in, not the library); rank 0's does not."""
    if dist.get_rank() == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    return collection
