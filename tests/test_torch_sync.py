"""The port's sync layer against the JAX package's, in one process.

``Metric.sync`` runs through the same fake ``dist_sync_fn`` in both packages:
it hands back the local states beside injected peers' (another metric of the
same class fed other seeded data), so both packages reduce the same per-rank
values. ``allreduce_over_mesh`` folds the same per-rank states in both: the JAX
package's on its 8 host devices (``tests/conftest.py``), the port's in place.
Integer states must be equal; float states and scores within rtol 1e-5;
Pearson and Spearman within rtol 1e-4. The errors of sync, unsync and
``sync_context``, the retries and the degraded merge follow.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.aggregation as ja
import metrics_tpu.classification as jc
import metrics_tpu.parallel.sync as jsync
import metrics_tpu.regression as jr
import metrics_tpu_torch.aggregation as ta
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.parallel as tsync
import metrics_tpu_torch.regression as tr
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

RTOL, CORR_RTOL = 1e-5, 1e-4
CLASSES = 5


def _np(x):
    if isinstance(x, list):
        return [_np(v) for v in x]
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(port, ref, rtol=RTOL):
    if isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _close(p, r, rtol)
        return
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=rtol, atol=1e-7)


def _shard(seed, n):
    rng = np.random.RandomState(seed)
    y = rng.randn(n).astype(np.float32)
    return {"x": (0.6 * y + 0.5 * rng.randn(n)).astype(np.float32), "y": y,
            "logits": rng.randn(n, CLASSES).astype(np.float32), "labels": rng.randint(0, CLASSES, n),
            "groups": rng.randint(0, 3, n), "binary": rng.randint(0, 2, n)}


# (name, port factory, JAX factory, feed(metric, shard, as_array), rtol)
METRICS = [
    ("MeanSquaredError", lambda: tr.MeanSquaredError(device="cpu"), jr.MeanSquaredError,
     lambda m, s, a: m.update(a(s["x"]), a(s["y"])), RTOL),
    ("PearsonCorrCoef", lambda: tr.PearsonCorrCoef(device="cpu"), jr.PearsonCorrCoef,
     lambda m, s, a: m.update(a(s["x"]), a(s["y"])), CORR_RTOL),
    ("SpearmanCorrCoef", lambda: tr.SpearmanCorrCoef(device="cpu"), jr.SpearmanCorrCoef,
     lambda m, s, a: m.update(a(s["x"]), a(s["y"])), CORR_RTOL),
    ("MeanMetric", lambda: ta.MeanMetric(device="cpu"), ja.MeanMetric,
     lambda m, s, a: m.update(a(s["x"])), RTOL),
    ("MaxMetric", lambda: ta.MaxMetric(device="cpu"), ja.MaxMetric, lambda m, s, a: m.update(a(s["x"])), RTOL),
    ("CatMetric", lambda: ta.CatMetric(device="cpu"), ja.CatMetric, lambda m, s, a: m.update(a(s["x"])), RTOL),
    ("MulticlassAccuracy", lambda: tc.MulticlassAccuracy(num_classes=CLASSES, device="cpu"),
     lambda: jc.MulticlassAccuracy(num_classes=CLASSES), lambda m, s, a: m.update(a(s["logits"]), a(s["labels"])),
     RTOL),
    ("BinaryFairness", lambda: tc.BinaryFairness(num_groups=3, device="cpu"),
     lambda: jc.BinaryFairness(num_groups=3),
     lambda m, s, a: m.update(a(1 / (1 + np.exp(-s["x"]))), a(s["binary"]), a(s["groups"])), RTOL),
]
IDS = [m[0] for m in METRICS]


def _fed(factory, feed, as_array, seeds_sizes):
    metric = factory()
    for seed, n in seeds_sizes:
        feed(metric, _shard(seed, n), as_array)
    return metric


def _fake_sync(peers, as_array):
    """A dist_sync_fn handing back each state beside the peers' values of the same state, in rank order."""
    def sync_fn(states, group):
        out = []
        for i, local in enumerate(states):
            ranks = [local]
            for peer in peers:
                value = list(peer.values())[i]
                if isinstance(value, list):
                    value = [as_array(np.concatenate([_np(v) for v in value]))] if value else []
                ranks.append(value)
            out.append(ranks)
        return out
    return sync_fn


def _peer_states(factory, feed, as_array, seeds):
    return [dict(_fed(factory, feed, as_array, [(seed, 20 + 3 * seed)]).metric_state) for seed in seeds]


# ----------------------------------------------------------------------------- Metric.sync, same fake transport
@pytest.mark.parametrize(("name", "port_make", "ref_make", "feed", "rtol"), METRICS, ids=IDS)
def test_sync_through_the_same_dist_sync_fn_matches_reference(name, port_make, ref_make, feed, rtol):
    port = _fed(port_make, feed, torch.from_numpy, [(1, 30)])
    ref = _fed(ref_make, feed, jnp.asarray, [(1, 30)])
    port_peers = _peer_states(port_make, feed, torch.from_numpy, [2, 3])
    ref_peers = _peer_states(ref_make, feed, jnp.asarray, [2, 3])
    local = {k: (list(v) if isinstance(v, list) else v) for k, v in port.metric_state.items()}
    port.sync(dist_sync_fn=_fake_sync(port_peers, torch.from_numpy), distributed_available=True)
    ref.sync(dist_sync_fn=_fake_sync(ref_peers, jnp.asarray), distributed_available=True)
    for key in ref.metric_state:
        _close(port.metric_state[key], ref.metric_state[key], rtol)
    if name == "PearsonCorrCoef":
        assert all(v.shape == (3,) for v in port.metric_state.values())
    port_value, ref_value = port._compute_impl(), ref._compute_impl()
    for p, r in (zip(port_value.values(), ref_value.values()) if isinstance(ref_value, dict) else [(port_value,
                                                                                                     ref_value)]):
        _close(p, r, rtol)
    port.unsync()
    for key, value in local.items():
        restored = port.metric_state[key]
        if isinstance(value, list):
            assert len(restored) == len(value) and all(a is b for a, b in zip(restored, value))
        else:
            assert restored is value


def test_sync_of_an_empty_rank_sends_a_placeholder():
    port, ref = ta.CatMetric(device="cpu"), ja.CatMetric()
    peers_t = [{"value": [torch.tensor([1.0, 2.0])]}]
    peers_j = [{"value": [jnp.asarray([1.0, 2.0])]}]
    seen = []

    def spy(fn):
        def wrapped(states, group):
            seen.append([_np(s) for s in states[0]])
            return fn(states, group)
        return wrapped

    port.sync(dist_sync_fn=spy(_fake_sync(peers_t, torch.from_numpy)), distributed_available=True)
    ref.sync(dist_sync_fn=_fake_sync(peers_j, jnp.asarray), distributed_available=True)
    assert seen[0][0].shape == (0,) and seen[0][0].dtype == np.float32
    _close(port.value, ref.value)


def test_sync_context_and_compute_sync_then_restore():
    port = _fed(lambda: tr.MeanSquaredError(device="cpu"), METRICS[0][3], torch.from_numpy, [(1, 30)])
    peers = _peer_states(lambda: tr.MeanSquaredError(device="cpu"), METRICS[0][3], torch.from_numpy, [2])
    local_total = port.total
    with port.sync_context(dist_sync_fn=_fake_sync(peers, torch.from_numpy), distributed_available=True):
        assert int(port.total) == 30 + 26
    assert port.total is local_total
    port.dist_sync_fn = _fake_sync(peers, torch.from_numpy)
    port.distributed_available_fn = lambda: True
    synced = port.compute()
    assert port.total is local_total and not port._is_synced
    unsynced = tr.MeanSquaredError(device="cpu")
    unsynced.update(torch.from_numpy(_shard(1, 30)["x"]), torch.from_numpy(_shard(1, 30)["y"]))
    assert float(synced) != float(unsynced.compute())


def test_clone_shares_the_process_group_handle():
    class Group:
        def __deepcopy__(self, memo):
            raise TypeError("a process group handle cannot be copied")

    group = Group()
    metric = ta.SumMetric(device="cpu", process_group=group)
    metric.update(torch.tensor(2.0))
    for copy in (metric.clone(), MetricCollection([metric]).clone()["SumMetric"]):
        assert copy.process_group is group and float(copy.compute()) == 2.0


def test_no_sync_without_a_process_group():
    port = _fed(lambda: tr.MeanSquaredError(device="cpu"), METRICS[0][3], torch.from_numpy, [(1, 30)])
    assert not port._distributed_available()
    port.sync()
    assert not port._is_synced


# ----------------------------------------------------------------------------- errors
def test_sync_unsync_and_context_errors_match_reference():
    from metrics_tpu.utils.exceptions import TPUMetricsUserError as RefUserError

    for make, array, UserError in ((lambda: ta.SumMetric(device="cpu"), torch.tensor, TPUMetricsUserError),
                                   (ja.SumMetric, jnp.asarray, RefUserError)):
        metric = make()
        metric.update(array(1.0))
        identity = lambda states, group: [[s] for s in states]  # noqa: E731
        with pytest.raises(UserError, match="already been un-synced"):
            metric.unsync()
        metric.sync(dist_sync_fn=identity, distributed_available=True)
        with pytest.raises(UserError, match="already been synced"):
            metric.sync(dist_sync_fn=identity, distributed_available=True)
        with pytest.raises(UserError, match="already been synced and cannot be updated"):
            metric.update(array(1.0))
        with pytest.raises(UserError, match="shouldn't be synced"):
            metric(array(1.0))
        metric._cache = None
        with pytest.raises(UserError, match="internal cache"):
            metric.unsync()
        metric.unsync(should_unsync=False)
        metric.reset()
        assert not metric._is_synced
        with metric.sync_context(dist_sync_fn=identity, distributed_available=False):
            assert not metric._is_synced


def test_merge_state_refuses_sync_on_step_as_reference():
    with pytest.raises(RuntimeError, match="dist_sync_on_step"):
        ja.SumMetric(dist_sync_on_step=True).merge_state(ja.SumMetric())
    with pytest.raises(RuntimeError, match="dist_sync_on_step"):
        ta.SumMetric(dist_sync_on_step=True, device="cpu").merge_state(ta.SumMetric(device="cpu"))


def test_non_associative_custom_reduction_is_refused():
    with pytest.raises(TPUMetricsUserError, match="merge_associative=False"):
        tsync.sync_states({"s": torch.zeros(2)}, {"s": lambda stack: stack[0]}, associative={"s": False})


def test_failed_sync_leaves_every_state_local():
    metric = ta.MeanMetric(device="cpu")
    metric.update(torch.tensor([1.0, 2.0]))
    local = dict(metric.metric_state)

    def half_then_fail(states, group):
        raise RuntimeError("peer went away")

    with pytest.raises(RuntimeError, match="peer went away"):
        metric.sync(dist_sync_fn=half_then_fail, distributed_available=True)
    assert metric.metric_state == local and not metric._is_synced and metric._cache is None


# ----------------------------------------------------------------------------- retries and degraded merge
def _flaky(failures, exc=RuntimeError("transient")):
    calls = {"n": 0}

    def sync_fn(states, group):
        calls["n"] += 1
        if calls["n"] <= failures:
            raise exc
        return [[s, s] for s in states]
    return sync_fn, calls


@pytest.mark.parametrize("package", ["port", "reference"])
def test_retries_then_success(package):
    sync, metric = (tsync, ta.SumMetric(device="cpu")) if package == "port" else (jsync, ja.SumMetric())
    metric.update(torch.tensor(2.0) if package == "port" else jnp.asarray(2.0))
    sync_fn, calls = _flaky(2)
    with sync.sync_policy(sync.SyncPolicy(retries=2, backoff_s=0.0)):
        metric.sync(dist_sync_fn=sync_fn, distributed_available=True)
    assert calls["n"] == 3 and float(metric.sum_value) == 4.0
    metric.unsync()
    sync_fn, calls = _flaky(5)
    with sync.sync_policy(sync.SyncPolicy(retries=1, backoff_s=0.0)):
        with pytest.raises(RuntimeError, match="transient"):
            metric.sync(dist_sync_fn=sync_fn, distributed_available=True)
    assert calls["n"] == 2 and float(metric.sum_value) == 2.0


def test_degraded_merge_matches_reference():
    survivors_t = [{"sum_value": torch.tensor(5.0)}, {"sum_value": torch.tensor(7.0)}]
    survivors_j = [{"sum_value": jnp.asarray(5.0)}, {"sum_value": jnp.asarray(7.0)}]
    results = []
    for sync, metric, array, survivors in ((tsync, ta.SumMetric(device="cpu"), torch.tensor, survivors_t),
                                           (jsync, ja.SumMetric(), jnp.asarray, survivors_j)):
        metric.update(array(1.0))
        lost = sync.SyncPeerLostError("lost a peer", survivors=survivors, survivor_counts=[2, 3])

        def sync_fn(states, group, lost=lost):
            raise lost

        with sync.sync_policy(sync.SyncPolicy(retries=3, backoff_s=0.0, partial_merge=True)):
            metric.sync(dist_sync_fn=sync_fn, distributed_available=True)
        assert metric._is_synced
        results.append(float(metric.sum_value))
        metric.unsync()
        assert float(metric.sum_value) == 1.0
        with sync.sync_policy(sync.SyncPolicy(partial_merge=False)):
            with pytest.raises(sync.SyncPeerLostError):
                metric.sync(dist_sync_fn=sync_fn, distributed_available=True)
    assert results == [13.0, 13.0]


def test_retry_jitter_and_policy_errors_match_reference():
    from metrics_tpu.parallel.sync import _jittered as ref_jittered
    from metrics_tpu_torch.parallel.sync import _jittered as port_jittered

    draws = []
    for sync, jittered in ((tsync, port_jittered), (jsync, ref_jittered)):
        sync.seed_retry_jitter(7)
        draws.append([jittered(0.2, 0.25) for _ in range(5)])
        with pytest.raises(Exception, match="SyncPolicy"):
            sync.set_sync_policy("retries=2")
    assert draws[0] == draws[1]
    with pytest.raises(TPUMetricsUserError, match="jitter"):
        port_jittered(0.1, 1.5)
    with pytest.raises(ValueError, match="survivor_counts"):
        tsync.SyncPeerLostError("x", survivors=[{}], survivor_counts=[1, 2])


# ----------------------------------------------------------------------------- allreduce_over_mesh
def _ranks(port_make, ref_make, feed, sizes):
    """Per-rank states of both packages; a size of 0 leaves the rank without an update."""
    port_states, ref_states = [], []
    for rank, n in enumerate(sizes):
        port, ref = port_make(), ref_make()
        if n:
            feed(port, _shard(40 + rank, n), torch.from_numpy)
            feed(ref, _shard(40 + rank, n), jnp.asarray)
        port_states.append(dict(port.metric_state))
        ref_states.append(dict(ref.metric_state))
    return port_states, ref_states, port_make(), ref_make()


@pytest.mark.parametrize(("name", "port_make", "ref_make", "feed", "rtol"), METRICS, ids=IDS)
def test_allreduce_over_mesh_matches_reference(name, port_make, ref_make, feed, rtol):
    # unequal ranks; the list-state metrics get an empty rank too
    sizes = [17, 0, 30, 9] if name in ("SpearmanCorrCoef", "CatMetric") else [17, 4, 30, 9]
    port_states, ref_states, port, ref = _ranks(port_make, ref_make, feed, sizes)
    merged = tsync.allreduce_over_mesh(port_states, port._reductions)
    want = jsync.allreduce_over_mesh(ref_states, ref._reductions)
    assert sorted(merged) == sorted(want)
    for key in want:
        _close(merged[key], want[key], rtol)
    port.load_merged_state(merged, update_count=len(sizes))
    ref.load_merged_state(want, update_count=len(sizes))
    for p, r in (zip(port.compute().values(), ref.compute().values()) if name == "BinaryFairness"
                 else [(port.compute(), ref.compute())]):
        _close(p, r, rtol)


def test_allreduce_over_mesh_contracts_match_reference():
    float_t = [{"m": torch.tensor([1.0, 2.0]), "n": torch.tensor(3, dtype=torch.int64),
                "g": torch.arange(r + 1, dtype=torch.float32)} for r in range(3)]
    float_j = [{k: jnp.asarray(v.numpy()) for k, v in st.items()} for st in float_t]
    reductions = {"m": "mean", "n": "mean", "g": None}
    port = tsync.allreduce_over_mesh(float_t, reductions)
    ref = jsync.allreduce_over_mesh(float_j, reductions)
    _close(port["m"], ref["m"])
    # the mean of an int64 state: the default float type, as the JAX package's int32 counter's under x32
    assert str(port["n"].dtype).replace("torch.", "") == str(ref["n"].dtype) == "float32"
    _close(port["n"], ref["n"])
    _close(port["g"], ref["g"])  # ragged None: the list of per-rank values
    with pytest.raises(NotImplementedError, match="unequal per-rank sizes"):
        tsync.allreduce_over_mesh([{"s": torch.ones(2)}, {"s": torch.ones(3)}], {"s": "sum"})
    with pytest.raises(NotImplementedError, match="unequal per-rank sizes"):
        jsync.allreduce_over_mesh([{"s": jnp.ones(2)}, {"s": jnp.ones(3)}], {"s": "sum"})
    empty = tsync.allreduce_over_mesh([{"c": []}, {"c": []}], {"c": "cat"})
    assert empty["c"].shape == (0,) and empty["c"].dtype == torch.float32


def test_pad_to_capacity_matches_reference():
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    port, n = tsync.pad_to_capacity(torch.from_numpy(x), 5, fill_value=-1.0)
    ref, m = jsync.pad_to_capacity(jnp.asarray(x), 5, fill_value=-1.0)
    _close(port, ref)
    assert int(n) == int(m) == 3 and n.dtype == torch.int32
    with pytest.raises(ValueError, match="Buffer overflow"):
        tsync.pad_to_capacity(torch.from_numpy(x), 2)


def test_parallel_exports_every_counterpart():
    import metrics_tpu.parallel as jp

    assert set(jp.__all__) - set(tsync.__all__) == {"shard_map_compat", "build_mesh"}
