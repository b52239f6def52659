"""The port's Metric runtime against the JAX package's: lifecycle, rollback, merge,
state transfer and the device rule.

Inputs come from seeded numpy and go through both packages; counts must agree
exactly and scores within rtol 1e-6 (the port divides its int64 counters in
float64 and rounds the quotient once to float32, the JAX package divides int32
counters in float32; both return float32).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu_torch.classification as tc
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.metric import Metric, resolve_device

RTOL = 1e-6


def _batches(seed, n_batches=4, n=64, num_classes=5):
    rng = np.random.RandomState(seed)
    return [
        (rng.rand(n, num_classes).astype(np.float32), rng.randint(0, num_classes, n).astype(np.int64))
        for _ in range(n_batches)
    ]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64), rtol=rtol)


class _SumAndSamples(Metric):
    """A metric with every kind of state: sum, mean, max, min and a list."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("avg", torch.zeros(()), dist_reduce_fx="mean")
        self.add_state("hi", torch.tensor(-float("inf")), dist_reduce_fx="max")
        self.add_state("lo", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("samples", [], dist_reduce_fx="cat")

    def update(self, x):
        self.total = self.total + x.sum()
        self.avg = x.mean()
        self.hi = torch.maximum(self.hi, x.max())
        self.lo = torch.minimum(self.lo, x.min())
        self.samples.append(x)

    def compute(self):
        return torch.stack([self.total, self.hi, self.lo, torch.cat(self.samples).sum()])


# ----------------------------------------------------------------------------- device rule
def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        assert tc.MulticlassAccuracy(num_classes=3).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.MulticlassAccuracy(num_classes=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    metric = tc.MulticlassAccuracy(num_classes=3, device="cpu")
    assert metric.device == torch.device("cpu")
    assert all(v.device.type == "cpu" for v in metric.metric_state.values())


def test_unknown_kwarg_raises():
    # jit_update, donate_states and compute_on_cpu are known options of the JAX package, taken by the port too
    with pytest.raises(ValueError, match="Unexpected keyword arguments"):
        tc.BinaryAccuracy(device="cpu", not_an_option=True)


# ----------------------------------------------------------------------------- lifecycle
@pytest.mark.parametrize("average", ["micro", "macro"])
def test_update_compute_matches_reference(average):
    ref = jc.MulticlassAccuracy(num_classes=5, average=average)
    port = tc.MulticlassAccuracy(num_classes=5, average=average, device="cpu")
    for p, t in _batches(0):
        ref.update(jnp.asarray(p), jnp.asarray(t))
        port.update(_t(p), _t(t))
    assert port.update_count == ref.update_count == 4
    _close(port.compute(), ref.compute())
    for name in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))


def test_compute_is_cached_until_next_update_and_reset():
    port = tc.MulticlassAccuracy(num_classes=5, device="cpu")
    (p0, t0), (p1, t1) = _batches(1, n_batches=2)
    port.update(_t(p0), _t(t0))
    first = port.compute()
    assert port.compute() is first
    port.update(_t(p1), _t(t1))
    assert port.compute() is not first
    port.reset()
    assert port.update_count == 0 and port._computed is None
    assert int(port.tp.sum()) == 0
    with pytest.warns(UserWarning, match="before the ``update``"):
        port.compute()


@pytest.mark.parametrize("full_state", [False, True])
def test_forward_matches_reference(full_state):
    class RefAcc(jc.MulticlassAccuracy):
        full_state_update = full_state

    class PortAcc(tc.MulticlassAccuracy):
        full_state_update = full_state

    ref = RefAcc(num_classes=5, average="macro")
    port = PortAcc(num_classes=5, average="macro", device="cpu")
    for p, t in _batches(2):
        _close(port(_t(p), _t(t)), ref(jnp.asarray(p), jnp.asarray(t)))
    assert port.update_count == ref.update_count
    _close(port.compute(), ref.compute())


def test_forward_reduce_state_merges_every_state_kind():
    rng = np.random.RandomState(3)
    xs = [torch.from_numpy(rng.rand(8).astype(np.float32)) for _ in range(3)]
    m = _SumAndSamples(device="cpu")
    batch_vals = [m(x) for x in xs]
    torch.testing.assert_close(batch_vals[1], torch.stack([xs[1].sum(), xs[1].max(), xs[1].min(), xs[1].sum()]))
    all_x = torch.cat(xs)
    torch.testing.assert_close(m.compute(), torch.stack([all_x.sum(), all_x.max(), all_x.min(), all_x.sum()]))
    # mean states weigh each side by its update count
    torch.testing.assert_close(m.avg, torch.stack([x.mean() for x in xs]).mean())
    assert m.update_count == 3 and len(m.samples) == 3


# ----------------------------------------------------------------------------- rollback
class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("depth", ["pre", "mid", "post"])
def test_raising_update_rolls_back_every_state(depth):
    m = _SumAndSamples(device="cpu")
    m.update(torch.arange(4.0))
    value = m.compute()
    before = {k: (list(v) if isinstance(v, list) else v.clone()) for k, v in m.metric_state.items()}
    real = m._update_impl

    def faulty(x):
        if depth == "mid":
            m.total = m.total + 100.0
            m.samples.append(x)
        elif depth == "post":
            real(x)
        raise _Boom(depth)

    m._update_impl = faulty
    with pytest.raises(_Boom):
        m.update(torch.ones(3))
    m._update_impl = real
    assert m.update_count == 1
    assert m._computed is value
    for k, v in before.items():
        now = m.metric_state[k]
        if isinstance(v, list):
            assert len(now) == len(v) and all(a is b for a, b in zip(now, v))
        else:
            torch.testing.assert_close(now, v)
    m.update(torch.ones(3))
    assert m.update_count == 2


def test_invalid_input_rolls_back_classification_metric():
    port = tc.MulticlassAccuracy(num_classes=5, device="cpu")
    p, t = _batches(4, n_batches=1)[0]
    port.update(_t(p), _t(t))
    tp = port.tp.clone()
    with pytest.raises(RuntimeError, match="more unique values"):
        port.update(_t(p), _t(np.arange(64) % 9))
    assert port.update_count == 1
    torch.testing.assert_close(port.tp, tp)


# ----------------------------------------------------------------------------- merge
@pytest.mark.parametrize("average", ["micro", "macro", "weighted"])
def test_merge_state_equals_single_pass(average):
    batches = _batches(5, n_batches=6)
    whole = tc.MulticlassAccuracy(num_classes=5, average=average, device="cpu")
    left = tc.MulticlassAccuracy(num_classes=5, average=average, device="cpu")
    right = tc.MulticlassAccuracy(num_classes=5, average=average, device="cpu")
    for i, (p, t) in enumerate(batches):
        whole.update(_t(p), _t(t))
        (left if i < 2 else right).update(_t(p), _t(t))
    left.merge_state(right)
    assert left.update_count == 6
    torch.testing.assert_close(left.compute(), whole.compute())
    merged = tc.MulticlassAccuracy(num_classes=5, average=average, device="cpu")
    merged.merge_state(whole.metric_state)
    assert merged.update_count == 1
    torch.testing.assert_close(merged.compute(), whole.compute())


def test_merge_state_refuses_bad_inputs():
    m = tc.BinaryAccuracy(device="cpu")
    with pytest.raises(ValueError, match="dict or an instance"):
        m.merge_state(3)
    with pytest.raises(ValueError, match="instance of BinaryAccuracy"):
        m.merge_state(tc.MulticlassAccuracy(num_classes=3, device="cpu"))

    class Full(tc.BinaryAccuracy):
        full_state_update = True

    with pytest.raises(RuntimeError, match="full_state_update=True"):
        Full(device="cpu").merge_state({})


# ----------------------------------------------------------------------------- state transfer
def test_state_dict_round_trip_in_port():
    src = tc.MulticlassAccuracy(num_classes=5, average="macro", device="cpu")
    src.persistent(True)
    for p, t in _batches(6, n_batches=2):
        src.update(_t(p), _t(t))
    dst = tc.MulticlassAccuracy(num_classes=5, average="macro", device="cpu")
    dst.load_state_dict(src.state_dict())
    assert dst.update_count == 2
    torch.testing.assert_close(dst.compute(), src.compute())
    with pytest.raises(RuntimeError, match="expects"):
        dst.load_state_dict({"tp": torch.zeros(4, dtype=torch.int64)}, strict=False)
    dst.persistent(True)
    with pytest.raises(RuntimeError, match="Missing key"):
        dst.load_state_dict({"_update_count": 1})


@pytest.mark.parametrize("average", ["micro", "macro"])
def test_load_reference_state_round_trip(average):
    ref = jc.MulticlassAccuracy(num_classes=5, average=average)
    ref.persistent(True)
    for p, t in _batches(7, n_batches=3):
        ref.update(jnp.asarray(p), jnp.asarray(t))
    port = load_reference_state(tc.MulticlassAccuracy(num_classes=5, average=average, device="cpu"), ref.state_dict())
    assert port.update_count == 3
    assert port.tp.dtype == torch.int64
    _close(port.compute(), ref.compute())


def test_load_reference_state_list_states():
    ref = jc.BinaryPrecisionRecallCurve(thresholds=None)
    ref.persistent(True)
    rng = np.random.RandomState(8)
    p, t = rng.rand(40).astype(np.float32), rng.randint(0, 2, 40)
    ref.update(jnp.asarray(p), jnp.asarray(t))
    port = load_reference_state(tc.BinaryPrecisionRecallCurve(thresholds=None, device="cpu"), ref.state_dict())
    assert len(port.preds) == 1
    for got, want in zip(port.compute(), ref.compute()):
        _close(got, want)


def test_load_reference_state_validates_before_installing():
    ref = jc.MulticlassAccuracy(num_classes=5, average="macro")
    ref.persistent(True)
    p, t = _batches(9, n_batches=1)[0]
    ref.update(jnp.asarray(p), jnp.asarray(t))
    good = ref.state_dict()
    port = tc.MulticlassAccuracy(num_classes=5, average="macro", device="cpu")

    bad_cases = [
        ({k: v for k, v in good.items() if k != "fn"}, "missing"),
        ({**good, "extra": np.zeros(5)}, "unknown"),
        ({**good, "fn": np.zeros(4, np.int32)}, "shape"),
        ({**good, "fn": np.zeros(5, np.float32)}, "kind"),
        ({**good, "_update_count": -1}, "_update_count"),
        ({**good, "fn": np.array(["a"] * 5)}, "numeric"),
    ]
    for state, match in bad_cases:
        with pytest.raises(ValueError, match=match):
            load_reference_state(port, state)
        assert port.update_count == 0
        assert int(port.tp.sum()) == 0
    # the unpersisted JAX state dict carries only the count
    with pytest.raises(ValueError, match="persistent"):
        load_reference_state(port, jc.MulticlassAccuracy(num_classes=5).state_dict())


def test_task_wrapper_dispatch():
    assert isinstance(tc.Accuracy(task="binary", device="cpu"), tc.BinaryAccuracy)
    assert isinstance(tc.Accuracy(task="multiclass", num_classes=3, device="cpu"), tc.MulticlassAccuracy)
    assert isinstance(tc.Accuracy(task="multilabel", num_labels=3, device="cpu"), tc.MultilabelAccuracy)
    assert isinstance(tc.StatScores(task="binary", device="cpu"), tc.BinaryStatScores)
    with pytest.raises(ValueError, match="num_classes"):
        tc.Accuracy(task="multiclass", device="cpu")
    with pytest.raises(RuntimeError, match="Can't change const"):
        tc.BinaryAccuracy(device="cpu").higher_is_better = False


# ----------------------------------------------------------------------------- constructor options
def _cat_and_spearman(**kw):
    from metrics_tpu_torch import CatMetric
    from metrics_tpu_torch.regression import SpearmanCorrCoef

    return [CatMetric(device="cpu", **kw), SpearmanCorrCoef(device="cpu", **kw)]


def _feed(metrics, seed=4):
    rng = np.random.RandomState(seed)
    for _ in range(3):
        x, y = rng.randn(40).astype(np.float32), rng.randn(40).astype(np.float32)
        metrics[0].update(_t(x))
        metrics[1].update(_t(x), _t(y))


def test_compute_on_cpu_keeps_list_states_on_the_host_with_equal_results():
    """compute_on_cpu=True: list states on the CPU after update and forward, through a sync, an unsync and
    pickling, with the results of the plain metrics and of the JAX package's."""
    import pickle

    from metrics_tpu import CatMetric as RefCat
    from metrics_tpu.regression import SpearmanCorrCoef as RefSpearman

    offloaded, plain = _cat_and_spearman(compute_on_cpu=True), _cat_and_spearman()
    refs = [RefCat(compute_on_cpu=True), RefSpearman(compute_on_cpu=True)]
    _feed(offloaded)
    _feed(plain)
    rng = np.random.RandomState(4)
    for _ in range(3):
        x, y = rng.randn(40).astype(np.float32), rng.randn(40).astype(np.float32)
        refs[0].update(jnp.asarray(x))
        refs[1].update(jnp.asarray(x), jnp.asarray(y))
    offloaded[0](_t(np.ones(3, np.float32)))
    plain[0](_t(np.ones(3, np.float32)))
    refs[0](jnp.ones(3, jnp.float32))
    for metric in offloaded:
        assert metric.compute_on_cpu
        for value in metric.metric_state.values():
            assert all(v.device.type == "cpu" for v in value)
        metric.sync(dist_sync_fn=lambda states, group: [[s] for s in states], distributed_available=True)
        metric.unsync()
        assert all(v.device.type == "cpu" for value in metric.metric_state.values() for v in value)
        again = pickle.loads(pickle.dumps(metric))
        assert all(isinstance(value, list) for value in again.metric_state.values())
    for metric, twin, ref in zip(offloaded, plain, refs):
        torch.testing.assert_close(metric.compute(), twin.compute(), rtol=0, atol=0)
        np.testing.assert_allclose(metric.compute().numpy(), np.asarray(ref.compute()), rtol=1e-5)


@pytest.mark.parametrize("option", [{"jit_update": True}, {"jit_update": False}, {"donate_states": True},
                                    {"donate_states": False}, {"jit_update": True, "donate_states": True}])
def test_jit_update_and_donate_states_are_accepted_and_change_nothing(option):
    ref = jc.MulticlassAccuracy(num_classes=5, average="macro", **option)
    port = tc.MulticlassAccuracy(num_classes=5, average="macro", device="cpu", **option)
    plain = tc.MulticlassAccuracy(num_classes=5, average="macro", device="cpu")
    assert port._jit_update_opt == ref._jit_update_opt == option.get("jit_update")
    assert port._donate_opt == ref._donate_opt == option.get("donate_states")
    for p, t in _batches(6):
        ref.update(jnp.asarray(p), jnp.asarray(t))
        port.update(_t(p), _t(t))
        plain.update(_t(p), _t(t))
    for key, value in plain.metric_state.items():
        assert torch.equal(port.metric_state[key], value), key
    _close(port.compute(), ref.compute())
