"""The port's classification metrics against the JAX package's on the same seeded inputs.

Stat scores and binned confusion counts must be integer-equal (int64 in the
port, int32 in the JAX package: values, not dtypes, are compared); accuracy and
curve values must agree within rtol 1e-6, and scores have the JAX package's
dtypes: float32 under the defaults, float64 with torch's default dtype set to
float64 and JAX's x64 on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.functional.classification as jf
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional.classification as tf
from metrics_tpu.functional.classification.precision_recall_curve import _adjust_threshold_arg as j_thresholds
from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg as t_thresholds

RTOL = 1e-6
N = 48
C = 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.array(x))


def _assert_same(port, ref, exact=False):
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_same(p, r, exact)
        return
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64), rtol=RTOL, atol=1e-7)


def _binary_inputs(seed, kind, extra_dim=False):
    rng = np.random.RandomState(seed)
    shape = (N, 3) if extra_dim else (N,)
    target = rng.randint(0, 2, shape)
    if kind == "probs":
        preds = rng.rand(*shape).astype(np.float32)
    elif kind == "logits":
        preds = (rng.randn(*shape) * 3).astype(np.float32)
    else:
        preds = rng.randint(0, 2, shape)
    return preds, target


def _multiclass_inputs(seed, kind, extra_dim=False):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, C, (N, 3) if extra_dim else (N,))
    if kind == "probs":
        preds = rng.rand(N, C, 3).astype(np.float32) if extra_dim else rng.rand(N, C).astype(np.float32)
    elif kind == "logits":
        preds = (rng.randn(*((N, C, 3) if extra_dim else (N, C))) * 3).astype(np.float32)
    else:
        preds = rng.randint(0, C, target.shape)
    return preds, target


def _with_ignore(target, ignore_index, seed):
    if ignore_index is None:
        return target
    target = target.copy()
    target[np.random.RandomState(seed).rand(*target.shape) < 0.2] = ignore_index
    return target


# ----------------------------------------------------------------------------- stat scores
@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_stat_scores_and_accuracy(kind, multidim_average, ignore_index):
    preds, target = _binary_inputs(1, kind, extra_dim=True)
    target = _with_ignore(target, ignore_index, 2)
    args = dict(multidim_average=multidim_average, ignore_index=ignore_index)
    _assert_same(tf.binary_stat_scores(_t(preds), _t(target), **args),
                 jf.binary_stat_scores(_j(preds), _j(target), **args), exact=True)
    _assert_same(tf.binary_accuracy(_t(preds), _t(target), **args),
                 jf.binary_accuracy(_j(preds), _j(target), **args))


@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, 1])
def test_multiclass_stat_scores_and_accuracy(kind, average, ignore_index):
    preds, target = _multiclass_inputs(3, kind)
    target = _with_ignore(target, ignore_index, 4)
    args = dict(num_classes=C, average=average, ignore_index=ignore_index)
    _assert_same(tf.multiclass_stat_scores(_t(preds), _t(target), **args),
                 jf.multiclass_stat_scores(_j(preds), _j(target), **args), exact=average in ("micro", "none"))
    _assert_same(tf.multiclass_accuracy(_t(preds), _t(target), **args),
                 jf.multiclass_accuracy(_j(preds), _j(target), **args))


@pytest.mark.parametrize("top_k", [2, 3])
@pytest.mark.parametrize("average", ["micro", "macro", "none"])
@pytest.mark.parametrize("ignore_index", [None, 0])
def test_multiclass_top_k(top_k, average, ignore_index):
    rng = np.random.RandomState(5)
    # a coarse grid of scores makes ties, which both packages must break toward the lower class
    preds = (rng.randint(0, 4, (N, C)) / 4).astype(np.float32)
    target = _with_ignore(rng.randint(0, C, N), ignore_index, 6)
    args = dict(num_classes=C, average=average, top_k=top_k, ignore_index=ignore_index)
    _assert_same(tf.multiclass_stat_scores(_t(preds), _t(target), **args),
                 jf.multiclass_stat_scores(_j(preds), _j(target), **args), exact=average != "macro")
    _assert_same(tf.multiclass_accuracy(_t(preds), _t(target), **args),
                 jf.multiclass_accuracy(_j(preds), _j(target), **args))


@pytest.mark.parametrize("kind", ["probs", "labels"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multiclass_samplewise(kind, average):
    preds, target = _multiclass_inputs(7, kind, extra_dim=True)
    target = _with_ignore(target, 2, 8)
    args = dict(num_classes=C, average=average, multidim_average="samplewise", ignore_index=2)
    _assert_same(tf.multiclass_stat_scores(_t(preds), _t(target), **args),
                 jf.multiclass_stat_scores(_j(preds), _j(target), **args), exact=average in ("micro", "none"))
    _assert_same(tf.multiclass_accuracy(_t(preds), _t(target), **args),
                 jf.multiclass_accuracy(_j(preds), _j(target), **args))


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_stat_scores_and_accuracy(average, multidim_average, ignore_index):
    rng = np.random.RandomState(9)
    preds = rng.rand(N, C, 3).astype(np.float32)
    target = _with_ignore(rng.randint(0, 2, (N, C, 3)), ignore_index, 10)
    args = dict(num_labels=C, average=average, multidim_average=multidim_average, ignore_index=ignore_index)
    _assert_same(tf.multilabel_stat_scores(_t(preds), _t(target), **args),
                 jf.multilabel_stat_scores(_j(preds), _j(target), **args), exact=average in ("micro", "none"))
    _assert_same(tf.multilabel_accuracy(_t(preds), _t(target), **args),
                 jf.multilabel_accuracy(_j(preds), _j(target), **args))


@pytest.mark.parametrize(
    ("port_cls", "ref_cls", "kwargs", "inputs"),
    [
        (tc.BinaryAccuracy, jc.BinaryAccuracy, {}, "binary"),
        (tc.BinaryStatScores, jc.BinaryStatScores, {"multidim_average": "samplewise"}, "binary"),
        (tc.MulticlassAccuracy, jc.MulticlassAccuracy, {"num_classes": C, "average": "micro"}, "multiclass"),
        (tc.MulticlassAccuracy, jc.MulticlassAccuracy, {"num_classes": C, "top_k": 2}, "multiclass"),
        (tc.MulticlassStatScores, jc.MulticlassStatScores, {"num_classes": C, "average": None}, "multiclass"),
        (tc.MultilabelAccuracy, jc.MultilabelAccuracy, {"num_labels": C}, "multilabel"),
        (tc.MultilabelStatScores, jc.MultilabelStatScores, {"num_labels": C, "average": "micro"}, "multilabel"),
    ],
)
def test_metric_classes_over_several_updates(port_cls, ref_cls, kwargs, inputs):
    port = port_cls(device="cpu", **kwargs)
    ref = ref_cls(**kwargs)
    for seed in range(3):
        rng = np.random.RandomState(20 + seed)
        if inputs == "binary":
            preds, target = rng.rand(N, 2).astype(np.float32), rng.randint(0, 2, (N, 2))
        elif inputs == "multiclass":
            preds, target = rng.rand(N, C).astype(np.float32), rng.randint(0, C, N)
        else:
            preds, target = rng.rand(N, C).astype(np.float32), rng.randint(0, 2, (N, C))
        _assert_same(port(_t(preds), _t(target)), ref(_j(preds), _j(target)))
    _assert_same(port.compute(), ref.compute())


def test_accuracy_task_wrapper_matches_reference():
    preds, target = _multiclass_inputs(11, "probs")
    port = tc.Accuracy(task="multiclass", num_classes=C, device="cpu")
    ref = jc.Accuracy(task="multiclass", num_classes=C)
    port.update(_t(preds), _t(target))
    ref.update(_j(preds), _j(target))
    _assert_same(port.compute(), ref.compute())
    _assert_same(tf.accuracy(_t(preds), _t(target), task="multiclass", num_classes=C),
                 jf.accuracy(_j(preds), _j(target), task="multiclass", num_classes=C))


# ----------------------------------------------------------------------------- threshold bits
@pytest.mark.parametrize("num", [1, 2, 5, 17, 100, 129, 200, 1000, 1024])
def test_int_thresholds_are_jnp_linspace_bit_for_bit(num):
    port = t_thresholds(num).numpy()
    ref = np.asarray(j_thresholds(num))
    assert port.dtype == np.float32
    np.testing.assert_array_equal(port.view(np.uint32), ref.view(np.uint32))


def test_torch_linspace_would_differ():
    """The reason the port does not call torch.linspace: it differs from jnp.linspace at T=200."""
    assert not np.array_equal(torch.linspace(0, 1, 200).numpy(), np.asarray(j_thresholds(200)))


# ----------------------------------------------------------------------------- PR curves
def _on_thresholds(num, n, seed):
    """Scores that land exactly on the thresholds, and some between them."""
    rng = np.random.RandomState(seed)
    grid = np.asarray(j_thresholds(num))
    on = grid[rng.randint(0, num, n // 2)]
    return np.concatenate([on, rng.rand(n - n // 2).astype(np.float32)])


@pytest.mark.parametrize("thresholds", [5, 100, 200, 1000])
def test_binary_curve_binned_on_threshold_scores(thresholds):
    rng = np.random.RandomState(12)
    preds = _on_thresholds(thresholds, 200, 13)
    target = rng.randint(0, 2, 200)
    port = tc.BinaryPrecisionRecallCurve(thresholds=thresholds, device="cpu")
    ref = jc.BinaryPrecisionRecallCurve(thresholds=thresholds)
    port.update(_t(preds), _t(target))
    ref.update(_j(preds), _j(target))
    _assert_same(port.confmat, ref.confmat, exact=True)
    _assert_same(port.compute(), ref.compute())


@pytest.mark.parametrize(
    "thresholds",
    [None, 11, [0.1, 0.5, 0.5, 0.9, 0.3], "tensor"],
    ids=["exact", "int", "list-unsorted-ties", "tensor-unsorted"],
)
@pytest.mark.parametrize("kind", ["probs", "logits", "ties", "nan"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_precision_recall_curve(thresholds, kind, ignore_index):
    rng = np.random.RandomState(14)
    preds, target = _binary_inputs(15, "logits" if kind == "logits" else "probs")
    if kind == "ties":
        preds = (rng.randint(0, 8, N) / 8).astype(np.float32)
    if kind == "nan":
        preds[rng.rand(N) < 0.2] = np.nan
    target = _with_ignore(target, ignore_index, 16)
    if thresholds == "tensor":
        t_thr, j_thr = _t(np.array([0.7, 0.2, 0.9, 0.2, 0.0], np.float32)), _j(np.array([0.7, 0.2, 0.9, 0.2, 0.0],
                                                                                         np.float32))
    else:
        t_thr = j_thr = thresholds
    port = tf.binary_precision_recall_curve(_t(preds), _t(target), thresholds=t_thr, ignore_index=ignore_index)
    ref = jf.binary_precision_recall_curve(_j(preds), _j(target), thresholds=j_thr, ignore_index=ignore_index)
    _assert_same(port, ref)


@pytest.mark.parametrize("thresholds", [None, 7, 200])
@pytest.mark.parametrize("average", [None, "micro", "macro"])
@pytest.mark.parametrize("kind", ["probs", "logits"])
def test_multiclass_precision_recall_curve(thresholds, average, kind):
    preds, target = _multiclass_inputs(17, kind)
    target = _with_ignore(target, -1, 18)
    args = dict(num_classes=C, thresholds=thresholds, average=average, ignore_index=-1)
    _assert_same(tf.multiclass_precision_recall_curve(_t(preds), _t(target), **args),
                 jf.multiclass_precision_recall_curve(_j(preds), _j(target), **args))


@pytest.mark.parametrize("thresholds", [None, 5, 100])
@pytest.mark.parametrize("average", [None, "micro"])
def test_multiclass_curve_metric_over_several_updates(thresholds, average):
    port = tc.MulticlassPrecisionRecallCurve(num_classes=C, thresholds=thresholds, average=average, device="cpu")
    ref = jc.MulticlassPrecisionRecallCurve(num_classes=C, thresholds=thresholds, average=average)
    for seed in range(3):
        rng = np.random.RandomState(30 + seed)
        preds = rng.rand(N, C).astype(np.float32)
        if thresholds:
            preds[:, 0] = _on_thresholds(thresholds, N, seed)
        preds, target = _t(preds), rng.randint(0, C, N)
        port.update(preds, _t(target))
        ref.update(_j(preds.numpy()), _j(target))
    if thresholds:
        _assert_same(port.confmat, ref.confmat, exact=True)
    _assert_same(port.compute(), ref.compute())


def test_binary_curve_exact_without_positives_warns_like_reference():
    preds, target = np.linspace(0, 1, 10, dtype=np.float32), np.zeros(10, np.int64)
    with pytest.warns(UserWarning, match="No positive samples"):
        port = tf.binary_precision_recall_curve(_t(preds), _t(target))
    with pytest.warns(UserWarning, match="No positive samples"):
        ref = jf.binary_precision_recall_curve(_j(preds), _j(target))
    _assert_same(port, ref)


def test_curve_argument_validation():
    with pytest.raises(ValueError, match="larger than 1"):
        tc.BinaryPrecisionRecallCurve(thresholds=1, device="cpu")
    with pytest.raises(ValueError, match="floats in the"):
        tc.BinaryPrecisionRecallCurve(thresholds=[0.5, 2.0], device="cpu")
    with pytest.raises(ValueError, match="average"):
        tc.MulticlassPrecisionRecallCurve(num_classes=3, average="weighted", device="cpu")
    with pytest.raises(RuntimeError, match="Detected the following values"):
        tf.binary_precision_recall_curve(torch.rand(4), torch.tensor([0, 1, 2, 1]))
    # the multilabel curve is ported: without num_labels it refuses, as the JAX package's dispatcher does
    with pytest.raises(ValueError, match="num_labels"):
        tf.precision_recall_curve(torch.rand(4, 2), torch.ones(4, 2, dtype=torch.long), task="multilabel")
    precision, _, _ = tf.precision_recall_curve(torch.rand(4, 2), torch.ones(4, 2, dtype=torch.long),
                                                task="multilabel", thresholds=5, num_labels=2)
    assert precision.shape == (2, 6)


# ----------------------------------------------------------------------------- score dtypes
def _dtype_case_inputs(inputs):
    rng = np.random.RandomState(50)
    if inputs == "binary":
        return rng.rand(N).astype(np.float32), rng.randint(0, 2, N)
    if inputs == "multiclass":
        return rng.rand(N, C).astype(np.float32), rng.randint(0, C, N)
    return rng.rand(N, C).astype(np.float32), rng.randint(0, 2, (N, C))


def _run_both(port_cls, ref_cls, kwargs, inputs):
    preds, target = _dtype_case_inputs(inputs)
    port = port_cls(device="cpu", **kwargs)
    ref = ref_cls(**kwargs)
    port.update(_t(preds), _t(target))
    ref.update(_j(preds), _j(target))
    got, want = port.compute(), ref.compute()
    return (list(got), list(want)) if isinstance(got, tuple) else ([got], [want])


@pytest.mark.parametrize(
    ("port_cls", "ref_cls", "kwargs", "inputs"),
    [
        (tc.BinaryAccuracy, jc.BinaryAccuracy, {}, "binary"),
        *[(tc.MulticlassAccuracy, jc.MulticlassAccuracy, {"num_classes": C, "average": a}, "multiclass")
          for a in ("micro", "macro", "weighted")],
        *[(tc.MultilabelAccuracy, jc.MultilabelAccuracy, {"num_labels": C, "average": a}, "multilabel")
          for a in ("micro", "macro", "weighted")],
        (tc.BinaryPrecisionRecallCurve, jc.BinaryPrecisionRecallCurve, {"thresholds": 20}, "binary"),
        (tc.MulticlassPrecisionRecallCurve, jc.MulticlassPrecisionRecallCurve, {"num_classes": C, "thresholds": 20},
         "multiclass"),
        (tc.MulticlassPrecisionRecallCurve, jc.MulticlassPrecisionRecallCurve,
         {"num_classes": C, "thresholds": 20, "average": "macro"}, "multiclass"),
    ],
    ids=["binary-acc", "multiclass-acc-micro", "multiclass-acc-macro", "multiclass-acc-weighted",
         "multilabel-acc-micro", "multilabel-acc-macro", "multilabel-acc-weighted", "binary-prc", "multiclass-prc",
         "multiclass-prc-macro"],
)
def test_scores_have_the_reference_dtype(port_cls, ref_cls, kwargs, inputs):
    """float32 scores under the defaults (the JAX package's x32); float64 with torch's default dtype set to
    float64, as the JAX package gives under x64."""
    got, want = _run_both(port_cls, ref_cls, kwargs, inputs)
    assert [str(g.dtype).replace("torch.", "") for g in got] == [str(w.dtype) for w in want]
    assert all(g.dtype == torch.float32 for g in got)
    _assert_same(got, want)
    previous = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        with jax.enable_x64(True):
            got, want = _run_both(port_cls, ref_cls, kwargs, inputs)
    finally:
        torch.set_default_dtype(previous)
    assert [str(g.dtype).replace("torch.", "") for g in got] == [str(w.dtype) for w in want]
    assert got[0].dtype == torch.float64
    _assert_same(got, want)
