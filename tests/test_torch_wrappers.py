"""The port's wrappers against the JAX package's.

``ClasswiseWrapper``, ``MinMaxMetric``, the input transformers,
``MultitaskWrapper``, ``MetricTracker`` and ``MultioutputWrapper`` over the
port's classification and regression metrics, on the same seeded numpy inputs
in both packages: keys and best steps equal, float32 values within rtol 1e-5,
atol 1e-6. Also: ``remove_nans`` against per-output filtering, the wrappers'
argument errors in both packages, the refusal of metrics on different devices,
and every wrapper's state carried over from the JAX package by ``interop``.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.regression as jr
import metrics_tpu.wrappers as jw
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.regression as tr
import metrics_tpu_torch.wrappers as tw
from metrics_tpu import MetricCollection as JCollection
from metrics_tpu_torch import MetricCollection as TCollection
from metrics_tpu_torch.interop import load_reference_state

RTOL, ATOL = 1e-5, 1e-6
CLASSES, LABELS = 4, 5


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(port, ref):
    if isinstance(ref, dict):  # the JAX package's compute returns a dict's keys sorted (a pytree's order)
        assert isinstance(port, dict) and sorted(port) == sorted(ref), (list(port), list(ref))
        for k in ref:
            _close(port[k], ref[k])
        return
    if isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _close(p, r)
        return
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=ATOL)


def _multiclass(seed, n=60):
    rng = np.random.RandomState(seed)
    return rng.randn(n, CLASSES).astype(np.float32), rng.randint(0, CLASSES, n)


def _multilabel(seed, n=60):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, 2, (n, LABELS))
    return ((rng.rand(n, LABELS) + 0.5 * target) / 1.5).astype(np.float32), target


def _regression(seed, n=50, outputs=1):
    rng = np.random.RandomState(seed)
    shape = (n,) if outputs == 1 else (n, outputs)
    t = rng.randn(*shape).astype(np.float32)
    return (0.7 * t + 0.5 * rng.randn(*shape)).astype(np.float32), t


def _feed(port, ref, batches, forward=False):
    out = []
    for a, b in batches:
        args_t, args_j = (torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b))), (jnp.asarray(a),
                                                                                              jnp.asarray(b))
        if forward:
            out.append((port(*args_t), ref(*args_j)))
        else:
            port.update(*args_t)
            ref.update(*args_j)
    return out


# ----------------------------------------------------------------------------- ClasswiseWrapper
CLASSWISE = [
    ("MulticlassAccuracy", lambda pk, **kw: pk.MulticlassAccuracy(num_classes=CLASSES, average=None, **kw),
     _multiclass, {}),
    ("MulticlassAccuracy", lambda pk, **kw: pk.MulticlassAccuracy(num_classes=CLASSES, average=None, **kw),
     _multiclass, {"labels": ["cat", "dog", "bird", "fish"]}),
    ("MulticlassRecall", lambda pk, **kw: pk.MulticlassRecall(num_classes=CLASSES, average=None, **kw),
     _multiclass, {"prefix": "recall/"}),
    ("MulticlassRecall", lambda pk, **kw: pk.MulticlassRecall(num_classes=CLASSES, average=None, **kw),
     _multiclass, {"postfix": "_rec", "labels": ["a", "b", "c", "d"]}),
    ("MultilabelAveragePrecision",
     lambda pk, **kw: pk.MultilabelAveragePrecision(num_labels=LABELS, thresholds=20, average=None, **kw),
     _multilabel, {"labels": ["person", "bicycle", "car", "motorcycle", "airplane"]}),
]
CLASSWISE_IDS = [f"{c[0]}-{sorted(c[3])}" for c in CLASSWISE]


@pytest.mark.parametrize(("name", "make", "data", "kwargs"), CLASSWISE, ids=CLASSWISE_IDS)
def test_classwise_matches_reference(name, make, data, kwargs):
    port = tw.ClasswiseWrapper(make(tc, device="cpu"), **kwargs)
    ref = jw.ClasswiseWrapper(make(jc), **kwargs)
    _feed(port, ref, [data(s) for s in (1, 2, 3)])
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    labels = kwargs.get("labels", range(CLASSES))
    assert list(got) == [f"{kwargs.get('prefix', '' if 'postfix' in kwargs else name.lower() + '_')}{lab}"
                         f"{kwargs.get('postfix', '')}" for lab in labels]
    if not kwargs:
        assert list(got) == [f"{name.lower()}_{i}" for i in range(CLASSES)]
    _close(got, want)


@pytest.mark.parametrize(("name", "make", "data", "kwargs"), CLASSWISE[:2] + CLASSWISE[4:],
                         ids=CLASSWISE_IDS[:2] + CLASSWISE_IDS[4:])
def test_classwise_forward_matches_reference(name, make, data, kwargs):
    port = tw.ClasswiseWrapper(make(tc, device="cpu"), **kwargs)
    ref = jw.ClasswiseWrapper(make(jc), **kwargs)
    for got, want in _feed(port, ref, [data(s) for s in (4, 5)], forward=True):
        _close(got, want)
    _close(port.compute(), ref.compute())
    port.reset()
    assert port.metric.update_count == 0


def test_classwise_values_are_the_wrapped_metrics():
    inner = tc.MulticlassAccuracy(num_classes=CLASSES, average=None, device="cpu")
    port = tw.ClasswiseWrapper(tc.MulticlassAccuracy(num_classes=CLASSES, average=None, device="cpu"))
    for p, t in (_multiclass(6), _multiclass(7)):
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        inner.update(torch.from_numpy(p), torch.from_numpy(t))
    assert torch.equal(torch.stack(list(port.compute().values())), inner.compute())
    assert port.metric_state is not None and set(port.metric_state) == set(inner.metric_state)


# ----------------------------------------------------------------------------- MinMaxMetric
MINMAX = [
    ("MeanSquaredError", lambda pk, **kw: pk.MeanSquaredError(**kw), _regression),
    ("BinaryAccuracy", lambda pk, **kw: pk.BinaryAccuracy(**kw),
     lambda s: (np.random.RandomState(s).rand(40).astype(np.float32), np.random.RandomState(s + 1).randint(0, 2, 40))),
]


@pytest.mark.parametrize(("name", "make", "data"), MINMAX, ids=[m[0] for m in MINMAX])
def test_minmax_matches_reference(name, make, data):
    pk_t = tr if name == "MeanSquaredError" else tc
    pk_j = jr if name == "MeanSquaredError" else jc
    port, ref = tw.MinMaxMetric(make(pk_t, device="cpu")), jw.MinMaxMetric(make(pk_j))
    batches = [data(s) for s in range(10, 15)]
    for got, want in _feed(port, ref, batches[:2], forward=True):
        _close(got, want)
    _feed(port, ref, batches[2:])
    got, want = port.compute(), ref.compute()
    assert sorted(got) == ["max", "min", "raw"]
    _close({k: got[k] for k in want}, want)
    assert port.min_val.dtype == torch.float32 and float(port.min_val) < float(port.max_val)
    port.reset()
    assert float(port.min_val) == float("inf") and port._base_metric.update_count == 0


def test_minmax_refuses_a_value_that_is_not_a_scalar_as_the_reference():
    p, t = _multiclass(16)
    port = tw.MinMaxMetric(tc.MulticlassAccuracy(num_classes=CLASSES, average=None, device="cpu"))
    ref = jw.MinMaxMetric(jc.MulticlassAccuracy(num_classes=CLASSES, average=None))
    with pytest.raises(RuntimeError, match="scalar"):
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    with pytest.raises(RuntimeError, match="scalar"):
        ref.update(jnp.asarray(p), jnp.asarray(t))
    with pytest.raises(ValueError, match="base metric"):
        tw.MinMaxMetric(lambda x: x)


# ----------------------------------------------------------------------------- input transformers
def _logits(seed, n=200):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, 2, n)
    return (rng.randn(n) + 1.5 * target).astype(np.float32), (0.6 * target + 0.4 * rng.rand(n)).astype(np.float32)


@pytest.mark.parametrize("forward", [False, True])
def test_lambda_input_transformer_matches_reference(forward):
    port = tw.LambdaInputTransformer(tc.BinaryAUROC(thresholds=20, device="cpu"), transform_pred=torch.sigmoid,
                                     transform_target=lambda t: (t > 0.5).long())
    ref = jw.LambdaInputTransformer(jc.BinaryAUROC(thresholds=20), transform_pred=lambda p: 1 / (1 + jnp.exp(-p)),
                                    transform_target=lambda t: (t > 0.5).astype(jnp.int32))
    pairs = _feed(port, ref, [_logits(s) for s in (20, 21, 22)], forward=forward)
    for got, want in pairs:
        _close(got, want)
    _close(port.compute(), ref.compute())
    # equal to the unwrapped metric on the transformed inputs
    plain = tc.BinaryAUROC(thresholds=20, device="cpu")
    for p, t in (_logits(s) for s in (20, 21, 22)):
        plain.update(torch.sigmoid(torch.from_numpy(p)), torch.from_numpy((t > 0.5).astype(np.int64)))
    assert torch.equal(port.compute(), plain.compute())


@pytest.mark.parametrize("threshold", [0.5, 0.0])
def test_binary_target_transformer_matches_reference(threshold):
    port = tw.BinaryTargetTransformer(tc.BinaryAUROC(thresholds=20, device="cpu"), threshold=threshold)
    ref = jw.BinaryTargetTransformer(jc.BinaryAUROC(thresholds=20), threshold=threshold)
    batches = [(1 / (1 + np.exp(-p)), t - 0.3) for p, t in (_logits(s) for s in (23, 24))]
    _feed(port, ref, batches)
    _close(port.compute(), ref.compute())
    assert port.transform_target(torch.tensor([threshold, threshold + 1])).tolist() == [0, 1]
    assert port.transform_target(torch.tensor([1.0])).dtype == torch.int32


def test_transformer_argument_errors_match_reference():
    for pk_w, pk_c, kw in ((tw, tc, {"device": "cpu"}), (jw, jc, {})):
        with pytest.raises(TypeError, match="transform_pred"):
            pk_w.LambdaInputTransformer(pk_c.BinaryAccuracy(**kw), transform_pred=1)
        with pytest.raises(TypeError, match="transform_target"):
            pk_w.LambdaInputTransformer(pk_c.BinaryAccuracy(**kw), transform_target="x")
        with pytest.raises(TypeError, match="threshold"):
            pk_w.BinaryTargetTransformer(pk_c.BinaryAccuracy(**kw), threshold="0.5")
        with pytest.raises(TypeError, match="wrapped metric"):
            pk_w.MetricInputTransformer(object())


def test_metric_input_transformer_is_the_identity():
    port = tw.MetricInputTransformer(tc.BinaryAccuracy(device="cpu"))
    plain = tc.BinaryAccuracy(device="cpu")
    p, t = torch.tensor([0.2, 0.8, 0.6]), torch.tensor([0, 1, 0])
    port.update(p, t)
    plain.update(p, t)
    assert torch.equal(port.compute(), plain.compute())
    port.reset()
    assert port.wrapped_metric.update_count == 0


# ----------------------------------------------------------------------------- MultitaskWrapper
def _tasks(pk_c, pk_r, collection, **kw):
    cls = pk_c.MulticlassAccuracy(num_classes=CLASSES, **kw)
    if collection:
        coll = TCollection if pk_c is tc else JCollection
        cls = coll([cls, pk_c.MulticlassF1Score(num_classes=CLASSES, **kw)])
    return {"cls": cls, "reg": pk_r.MeanSquaredError(**kw)}


def _task_batches(seeds):
    out = []
    for s in seeds:
        (logits, labels), (x, y) = _multiclass(s), _regression(s)
        out.append(({"cls": logits, "reg": x}, {"cls": labels, "reg": y}))
    return out


@pytest.mark.parametrize("collection", [False, True])
@pytest.mark.parametrize("forward", [False, True])
def test_multitask_matches_reference(collection, forward):
    port = tw.MultitaskWrapper(_tasks(tc, tr, collection, device="cpu"), prefix="val/")
    ref = jw.MultitaskWrapper(_tasks(jc, jr, collection), prefix="val/")
    for preds, target in _task_batches((30, 31, 32)):
        args_t = ({k: torch.from_numpy(np.asarray(v)) for k, v in preds.items()},
                  {k: torch.from_numpy(np.asarray(v)) for k, v in target.items()})
        args_j = ({k: jnp.asarray(v) for k, v in preds.items()}, {k: jnp.asarray(v) for k, v in target.items()})
        if forward:
            _close(port(*args_t), ref(*args_j))
        else:
            port.update(*args_t)
            ref.update(*args_j)
    got, want = port.compute(), ref.compute()
    assert list(got) == ["val/cls", "val/reg"]
    _close(got, want)
    assert list(port.keys()) == list(ref.keys()) and list(port.keys(flatten=False)) == list(ref.keys(flatten=False))
    clone = port.clone(prefix="test/", postfix="_x")
    assert list(clone.compute()) == ["test/cls_x", "test/reg_x"]
    _close(clone.compute()["test/reg_x"], got["val/reg"])
    port.reset()
    assert all(m.update_count == 0 for m in port.values())


def test_multitask_argument_errors_match_reference():
    for pk_w, pk_c, pk_r, kw in ((tw, tc, tr, {"device": "cpu"}), (jw, jc, jr, {})):
        with pytest.raises(TypeError, match="dict"):
            pk_w.MultitaskWrapper([pk_r.MeanSquaredError(**kw)])
        with pytest.raises(TypeError, match="Metric or a MetricCollection"):
            pk_w.MultitaskWrapper({"a": 1})
        with pytest.raises(ValueError, match="prefix"):
            pk_w.MultitaskWrapper({"a": pk_r.MeanSquaredError(**kw)}, prefix=1)
        wrapper = pk_w.MultitaskWrapper({"a": pk_r.MeanSquaredError(**kw)})
        with pytest.raises(ValueError, match="same keys"):
            wrapper.update({"b": 1}, {"b": 1})
        with pytest.raises(ValueError, match="prefix"):
            wrapper.clone(prefix=2)


# ----------------------------------------------------------------------------- MetricTracker
def _epochs(n_epochs=3, per_epoch=2):
    return [[_multiclass(100 * e + s) for s in range(per_epoch)] for e in range(n_epochs)]


@pytest.mark.parametrize("maximize", [True, False])
def test_tracker_over_a_metric_matches_reference(maximize):
    port = tw.MetricTracker(tc.MulticlassAccuracy(num_classes=CLASSES, device="cpu"), maximize=maximize)
    ref = jw.MetricTracker(jc.MulticlassAccuracy(num_classes=CLASSES), maximize=maximize)
    for batches in _epochs():
        port.increment()
        ref.increment()
        _feed(port, ref, batches)
        _close(port.compute(), ref.compute())
    assert port.n_steps == ref.n_steps == 3
    _close(port.compute_all(), ref.compute_all())
    (best, step), (want_best, want_step) = port.best_metric(return_step=True), ref.best_metric(return_step=True)
    assert step == want_step
    _close(best, want_best)
    _close(port.best_metric(), ref.best_metric())


@pytest.mark.parametrize("maximize", [True, [False, True, True]])
def test_tracker_over_a_collection_matches_reference(maximize):
    def members(pk, **kw):
        return [pk.MulticlassAccuracy(num_classes=CLASSES, **kw), pk.MulticlassPrecision(num_classes=CLASSES, **kw),
                pk.MulticlassRecall(num_classes=CLASSES, **kw)]

    port = tw.MetricTracker(TCollection(members(tc, device="cpu")), maximize=maximize)
    ref = jw.MetricTracker(JCollection(members(jc)), maximize=maximize)
    for batches in _epochs():
        port.increment()
        ref.increment()
        for got, want in _feed(port, ref, batches, forward=True):
            _close(got, want)
    _close(port.compute_all(), ref.compute_all())
    (best, steps), (want_best, want_steps) = port.best_metric(return_step=True), ref.best_metric(return_step=True)
    assert steps == want_steps
    _close(best, want_best)


def test_tracker_nan_and_non_scalar_values_warn_as_the_reference():
    port = tw.MetricTracker(tc.MulticlassAccuracy(num_classes=CLASSES, average=None, device="cpu"))
    ref = jw.MetricTracker(jc.MulticlassAccuracy(num_classes=CLASSES, average=None))
    for batches in _epochs(2, 1):
        port.increment()
        ref.increment()
        _feed(port, ref, batches)
    with pytest.warns(UserWarning, match="non-scalar"):
        assert port.best_metric(return_step=True) == (None, None)
    with pytest.warns(UserWarning, match="non-scalar"):
        assert ref.best_metric(return_step=True) == (None, None)
    nan = tw.MetricTracker(tr.MeanSquaredError(device="cpu"), maximize=False)
    nan.increment()
    nan.update(torch.tensor([float("nan")]), torch.tensor([1.0]))
    with pytest.warns(UserWarning, match="nan"):
        assert nan.best_metric() is None


def test_tracker_argument_errors_match_reference():
    for pk_w, pk_c, coll, kw in ((tw, tc, TCollection, {"device": "cpu"}), (jw, jc, JCollection, {})):
        with pytest.raises(TypeError, match="Metric"):
            pk_w.MetricTracker([1])
        with pytest.raises(ValueError, match="single bool or list"):
            pk_w.MetricTracker(pk_c.BinaryAccuracy(**kw), maximize=1)
        with pytest.raises(ValueError, match="single bool or list"):
            pk_w.MetricTracker(pk_c.BinaryAccuracy(**kw), maximize=[1])
        with pytest.raises(ValueError, match="single bool when"):
            pk_w.MetricTracker(pk_c.BinaryAccuracy(**kw), maximize=[True])
        with pytest.raises(ValueError, match="len of argument"):
            pk_w.MetricTracker(coll([pk_c.BinaryAccuracy(**kw)]), maximize=[True, False])
        tracker = pk_w.MetricTracker(pk_c.BinaryAccuracy(**kw))
        for method in ("update", "compute", "compute_all"):
            with pytest.raises(ValueError, match="increment"):
                getattr(tracker, method)(*(() if method != "update" else (1, 1)))


def test_tracker_compute_after_increment_is_the_new_step():
    tracker = tw.MetricTracker(tr.MeanSquaredError(device="cpu"), maximize=False)
    tracker.increment()
    tracker.update(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 4.0]))
    assert float(tracker.compute()) == 2.0
    tracker.increment()
    tracker.update(torch.tensor([1.0]), torch.tensor([2.0]))
    assert float(tracker.compute()) == 1.0
    assert tracker.best_metric(return_step=True) == (1.0, 1)
    tracker.reset_all()
    assert all(m.update_count == 0 for m in tracker._history)


# ----------------------------------------------------------------------------- MultioutputWrapper
MULTIOUTPUT = [
    ("R2Score", lambda pk, **kw: pk.R2Score(**kw)),
    ("MeanAbsoluteError", lambda pk, **kw: pk.MeanAbsoluteError(**kw)),
    ("PearsonCorrCoef", lambda pk, **kw: pk.PearsonCorrCoef(**kw)),
]


@pytest.mark.parametrize(("name", "make"), MULTIOUTPUT, ids=[m[0] for m in MULTIOUTPUT])
@pytest.mark.parametrize("forward", [False, True])
def test_multioutput_matches_reference_and_the_multi_output_metric(name, make, forward):
    port = tw.MultioutputWrapper(make(tr, device="cpu"), num_outputs=3)
    ref = jw.MultioutputWrapper(make(jr), num_outputs=3)
    batches = [_regression(s, outputs=3) for s in (40, 41, 42)]
    for got, want in _feed(port, ref, batches, forward=forward):
        _close(got, want)
    got = port.compute()
    _close(got, ref.compute())
    assert got.shape == (3,)
    if name == "R2Score":
        whole = tr.R2Score(num_outputs=3, multioutput="raw_values", device="cpu")
        for x, y in batches:
            whole.update(torch.from_numpy(x), torch.from_numpy(y))
        _close(got, whole.compute())


@pytest.mark.parametrize("output_dim", [-1, 1])
def test_multioutput_remove_nans_matches_reference(output_dim):
    port = tw.MultioutputWrapper(tr.R2Score(device="cpu"), num_outputs=3, output_dim=output_dim)
    ref = jw.MultioutputWrapper(jr.R2Score(), num_outputs=3, output_dim=output_dim)
    batches = []
    for s in (43, 44, 45):
        x, y = _regression(s, outputs=3)
        rng = np.random.RandomState(s)
        y[rng.rand(*y.shape) < 0.1] = np.nan
        x[rng.rand(*x.shape) < 0.05] = np.nan
        batches.append((x, y))
    _feed(port, ref, batches)
    got = port.compute()
    _close(got, ref.compute())
    # each output's metric saw exactly the rows without a NaN in its column
    for i, metric in enumerate(port.metrics):
        keep = np.concatenate([~(np.isnan(x[:, i]) | np.isnan(y[:, i])) for x, y in batches])
        assert int(metric.total) == int(keep.sum())
        xs = np.concatenate([x[:, i] for x, _ in batches])[keep]
        ys = np.concatenate([y[:, i] for _, y in batches])[keep]
        _close(got[i], tr.R2Score(device="cpu")(torch.from_numpy(xs), torch.from_numpy(ys)))


def test_multioutput_without_squeeze_or_nan_removal_matches_reference():
    port = tw.MultioutputWrapper(tr.MeanSquaredError(device="cpu"), num_outputs=2, remove_nans=False,
                                 squeeze_outputs=False)
    ref = jw.MultioutputWrapper(jr.MeanSquaredError(), num_outputs=2, remove_nans=False, squeeze_outputs=False)
    _feed(port, ref, [_regression(s, outputs=2) for s in (46, 47)])
    _close(port.compute(), ref.compute())


def test_multioutput_reads_the_nan_flags_once_per_update(monkeypatch):
    """Every output's NaN flags are found at once; the host reads the kept counts, one list, once."""
    port = tw.MultioutputWrapper(tr.MeanAbsoluteError(device="cpu"), num_outputs=4)
    reads = []
    original = torch.Tensor.tolist

    def counting(self):
        reads.append(tuple(self.shape))
        return original(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    x, y = _regression(48, outputs=4)
    y[3, 1] = np.nan
    port.update(torch.from_numpy(x), torch.from_numpy(y))
    assert reads == [(4,)]
    assert [int(m.total) for m in port.metrics] == [50, 49, 50, 50]


def test_multioutput_merge_equals_the_single_stream():
    batches = [_regression(s, outputs=3) for s in (49, 50, 51, 52)]
    whole, left, right = (tw.MultioutputWrapper(tr.MeanSquaredError(device="cpu"), num_outputs=3) for _ in range(3))
    for x, y in batches:
        whole.update(torch.from_numpy(x), torch.from_numpy(y))
    for metric, part in ((left, batches[:2]), (right, batches[2:])):
        for x, y in part:
            metric.update(torch.from_numpy(x), torch.from_numpy(y))
    left.merge_state(right)
    _close(left.compute(), whole.compute())


# ----------------------------------------------------------------------------- devices
def test_wrappers_refuse_metrics_on_different_devices():
    cpu, meta = tr.MeanSquaredError(device="cpu"), tr.MeanSquaredError(device="meta")
    with pytest.raises(ValueError, match="one device"):
        tw.MultitaskWrapper({"a": cpu, "b": meta})
    with pytest.raises(ValueError, match="one device"):
        tw.MultitaskWrapper({"a": TCollection([cpu]), "b": meta})
    with pytest.raises(ValueError, match="one device"):
        tw.MetricTracker(TCollection({"a": cpu, "b": meta}))
    for wrap in (lambda m: tw.ClasswiseWrapper(m, device="meta"), lambda m: tw.MinMaxMetric(m, device="meta"),
                 lambda m: tw.MultioutputWrapper(m, 2, device="meta"),
                 lambda m: tw.LambdaInputTransformer(m, device="meta")):
        with pytest.raises(ValueError, match="one device"):
            wrap(cpu)


def test_wrappers_live_on_their_metrics_device():
    for wrapper in (tw.ClasswiseWrapper(tc.MulticlassAccuracy(num_classes=3, average=None, device="cpu")),
                    tw.MinMaxMetric(tr.MeanSquaredError(device="cpu")),
                    tw.MultioutputWrapper(tr.R2Score(device="cpu"), 2),
                    tw.BinaryTargetTransformer(tc.BinaryAUROC(device="cpu")),
                    tw.MultitaskWrapper({"a": tr.MeanSquaredError(device="cpu")}),
                    tw.MetricTracker(tr.MeanSquaredError(device="cpu"))):
        assert wrapper.device == torch.device("cpu")


# ----------------------------------------------------------------------------- interop
def _collection_pair():
    return (TCollection([tc.MulticlassAccuracy(num_classes=CLASSES, device="cpu"),
                         tc.MulticlassRecall(num_classes=CLASSES, device="cpu")]),
            JCollection([jc.MulticlassAccuracy(num_classes=CLASSES), jc.MulticlassRecall(num_classes=CLASSES)]))


INTEROP = [
    ("ClasswiseWrapper", lambda: (tw.ClasswiseWrapper(tc.MulticlassAccuracy(num_classes=CLASSES, average=None,
                                                                             device="cpu")),
                                  jw.ClasswiseWrapper(jc.MulticlassAccuracy(num_classes=CLASSES, average=None))),
     _multiclass),
    ("MinMaxMetric", lambda: (tw.MinMaxMetric(tr.MeanSquaredError(device="cpu")),
                              jw.MinMaxMetric(jr.MeanSquaredError())), _regression),
    ("LambdaInputTransformer", lambda: (tw.LambdaInputTransformer(tr.MeanSquaredError(device="cpu"),
                                                                  transform_pred=lambda p: 2 * p),
                                        jw.LambdaInputTransformer(jr.MeanSquaredError(),
                                                                  transform_pred=lambda p: 2 * p)), _regression),
    ("MultioutputWrapper", lambda: (tw.MultioutputWrapper(tr.ExplainedVariance(device="cpu"), num_outputs=3),
                                    jw.MultioutputWrapper(jr.ExplainedVariance(), num_outputs=3)),
     lambda s: _regression(s, outputs=3)),
    ("MultitaskWrapper", lambda: (tw.MultitaskWrapper({"reg": tr.R2Score(device="cpu"),
                                                       "mae": tr.MeanAbsoluteError(device="cpu")}),
                                  jw.MultitaskWrapper({"reg": jr.R2Score(), "mae": jr.MeanAbsoluteError()})),
     lambda s: tuple({"reg": a, "mae": a} for a in _regression(s))),
    ("MultitaskWrapper[collection]", lambda: (tw.MultitaskWrapper({"cls": _collection_pair()[0]}),
                                              jw.MultitaskWrapper({"cls": _collection_pair()[1]})),
     lambda s: tuple({"cls": a} for a in _multiclass(s))),
    ("MetricTracker", lambda: (tw.MetricTracker(tr.NormalizedRootMeanSquaredError(device="cpu"), maximize=False),
                               jw.MetricTracker(jr.NormalizedRootMeanSquaredError(), maximize=False)), _regression),
]


def _as(conv, x):
    return {k: conv(np.asarray(v)) for k, v in x.items()} if isinstance(x, dict) else conv(np.asarray(x))


@pytest.mark.parametrize(("name", "make", "data"), INTEROP, ids=[c[0] for c in INTEROP])
def test_reference_state_loads_into_the_port(name, make, data):
    port, ref = make()
    batches = [data(s) for s in (60, 61, 62)]
    if name == "MetricTracker":
        for p in (port, ref):
            p.increment()
            p.increment()
    for a, b in batches[:2]:
        ref.update(_as(jnp.asarray, a), _as(jnp.asarray, b))
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    a, b = batches[2]
    ref.update(_as(jnp.asarray, a), _as(jnp.asarray, b))
    port.update(_as(torch.from_numpy, a), _as(torch.from_numpy, b))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _close(port.compute(), ref.compute())
    if name == "MetricTracker":
        _close(port.compute_all(), ref.compute_all())
