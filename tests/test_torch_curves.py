"""The port's binned curve family against the JAX package's: the binned path, the edge cases, the exports,
the dispatcher and state carried across.

Inputs, families and the tolerances are set out in ``tests/test_torch_curve_cases.py``; the exact path
(``thresholds=None``), the averages and the float64 regime have files of their own
(``tests/test_torch_curves_exact.py``, ``_averages.py``, ``_x64.py``) so that the test runner, which hands
each file to one worker, spreads them.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.functional.classification as jf
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional.classification as tf
from metrics_tpu_torch.interop import load_reference_state
from tests.test_torch_curve_cases import (
    C,
    FAMILIES,
    N,
    _assert_same,
    _compare,
    _inputs,
    _j,
    _run_class,
    _run_functional,
    _t,
    check_family,
)


@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("thresholds", [7, [0.1, 0.5, 0.5, 0.9, 0.3], "tensor"],
                         ids=["int", "list-unsorted-ties", "tensor-unsorted"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_reference(family, task, thresholds, ignore_index, kind):
    check_family(family, task, thresholds, ignore_index, kind)


@pytest.mark.parametrize("thresholds", [None, 20, "tensor"], ids=["exact", "int", "tensor-unsorted"])
@pytest.mark.parametrize("max_fpr", [0.05, 0.3, 0.5, 1.0])
def test_binary_auroc_max_fpr(max_fpr, thresholds):
    preds, target = _inputs("binary", "probs", None, seed=7)
    port, ref = _run_functional("auroc", "binary", preds, target, thresholds, None, {"max_fpr": max_fpr})
    _assert_same(port, ref, exact=False)
    port, ref = _run_class("auroc", "binary", [_inputs("binary", "probs", None, seed=s) for s in (8, 9)],
                           thresholds, None, {"max_fpr": max_fpr})
    _assert_same(port.compute(), ref.compute(), exact=False)


@pytest.mark.parametrize("fpr_range", [(0.0, 0.5), (0.05, 0.9), (0.1, 1.0)])
@pytest.mark.parametrize("thresholds", [None, 11])
def test_logauc_fpr_range(fpr_range, thresholds):
    preds, target = _inputs("binary", "probs", None, seed=10)
    port, ref = _run_functional("logauc", "binary", preds, target, thresholds, None, {"fpr_range": fpr_range})
    _assert_same(port, ref, exact=False)


# ----------------------------------------------------------------------------- edge cases
@pytest.mark.parametrize("thresholds", [None, 7], ids=["exact", "int"])
@pytest.mark.parametrize(("family", "average"), [("ap", "macro"), ("ap", "weighted"), ("auroc", "macro"),
                                                 ("auroc", "weighted")])
def test_class_without_positives_warns_and_is_dropped_like_reference(family, average, thresholds):
    """Class 3 never appears: the exact multiclass AP is NaN there and dropped from the average with a
    warning, as the JAX package warns eagerly; the exact ROC warns that the class has no positives."""
    rng = np.random.RandomState(11)
    preds = rng.rand(N, C).astype(np.float32)
    target = rng.randint(0, C - 1, N)
    stem = FAMILIES[family][0]
    args = dict(num_classes=C, average=average, thresholds=thresholds)
    warns = thresholds is None
    port_fn, ref_fn = getattr(tf, "multiclass_" + stem), getattr(jf, "multiclass_" + stem)
    if warns:
        match = "nan" if family == "ap" else "No positive samples"
        with pytest.warns(UserWarning, match=match):
            port = port_fn(_t(preds), _t(target), **args)
        with pytest.warns(UserWarning, match=match):
            ref = ref_fn(_j(preds), _j(target), **args)
    else:
        port, ref = port_fn(_t(preds), _t(target), **args), ref_fn(_j(preds), _j(target), **args)
    assert bool(torch.isfinite(port))
    _assert_same(port, ref, exact=False)
    per_class = port_fn(_t(preds), _t(target), **{**args, "average": "none"})
    if family == "ap" and thresholds is None:
        assert bool(torch.isnan(per_class[-1])) and bool(torch.isfinite(per_class[:-1]).all())


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("thresholds", [None, 7], ids=["exact", "int"])
def test_multilabel_targets_above_one_without_validation(family, thresholds):
    """``validate_args=False`` lets targets of 2 through: the binned update clamps them to 1, the exact
    path counts them as negatives, in both packages."""
    preds, target = _inputs("multilabel", "probs", None, seed=12)
    target = np.where(np.random.RandomState(13).rand(N, C) < 0.2, 2, target)
    extra = {**FAMILIES[family][2], "validate_args": False}
    port, ref = _run_functional(family, "multilabel", preds, target, thresholds, None, extra)
    _compare(port, ref, family, None, thresholds, "probs")


# ----------------------------------------------------------------------------- exports, dispatcher, state transfer
SLICE_MODULES = ["precision_recall_curve", "roc", "auroc", "average_precision", "logauc", "sensitivity_specificity",
                 "specificity_sensitivity", "precision_fixed_recall", "recall_fixed_precision"]


def _public_names(package, module_name):
    module = __import__(f"{package}.{module_name}", fromlist=["_"])
    return {name for name, obj in vars(module).items()
            if not name.startswith("_") and getattr(obj, "__module__", None) == module.__name__}


@pytest.mark.parametrize("layer", ["functional.classification", "classification"])
def test_port_exports_every_public_name_of_the_slice(layer):
    port = __import__(f"metrics_tpu_torch.{layer}", fromlist=["_"])
    missing = set()
    for module_name in SLICE_MODULES:
        names = _public_names(f"metrics_tpu.{layer}", module_name)
        assert names, module_name
        missing |= names - set(port.__all__)
        assert names <= set(vars(port)), module_name
    assert not missing


def test_auc_matches_reference():
    import metrics_tpu.utils.compute as jcompute
    import metrics_tpu_torch.utils.compute as tcompute

    rng = np.random.RandomState(15)
    x, y = rng.rand(30).astype(np.float32), rng.rand(30).astype(np.float32)
    for reorder in (False, True):
        for xs in (np.sort(x), np.sort(x)[::-1].copy(), x):
            if not reorder and xs is x:
                continue
            _assert_same(tcompute.auc(_t(xs), _t(y), reorder=reorder), jcompute.auc(_j(xs), _j(y), reorder=reorder),
                         exact=False)


def test_dispatcher_signature_matches_reference():
    port = inspect.signature(tf.precision_recall_curve).parameters
    ref = inspect.signature(jf.precision_recall_curve).parameters
    assert list(port) == list(ref)
    for name in ref:
        assert port[name].default == ref[name].default, name
        assert port[name].kind == ref[name].kind, name


@pytest.mark.parametrize("thresholds", [None, 7], ids=["exact", "int"])
def test_dispatcher_multilabel_matches_reference(thresholds):
    preds, target = _inputs("multilabel", "probs", -1, seed=16)
    # positional, in the JAX package's order: ignore_index lands after num_labels
    port = tf.precision_recall_curve(_t(preds), _t(target), "multilabel", thresholds, None, C, -1)
    ref = jf.precision_recall_curve(_j(preds), _j(target), "multilabel", thresholds, None, C, -1)
    _assert_same(port, ref, exact=True)


@pytest.mark.parametrize(
    ("port_cls", "ref_cls", "kwargs", "task"),
    [
        (tc.MultilabelAveragePrecision, jc.MultilabelAveragePrecision, {"num_labels": C, "thresholds": 50},
         "multilabel"),
        (tc.BinaryAUROC, jc.BinaryAUROC, {"thresholds": None}, "binary"),
        (tc.MulticlassROC, jc.MulticlassROC, {"num_classes": C, "thresholds": 9}, "multiclass"),
    ],
    ids=["multilabel-ap-binned", "binary-auroc-exact", "multiclass-roc-binned"],
)
def test_reference_state_carried_into_port(port_cls, ref_cls, kwargs, task):
    """The JAX metric's ``state_dict()`` (a binned int32 confusion tensor, or the exact path's list
    states) goes into the port's metric of the same configuration: the same ``compute()``, and the
    same again after one more batch in each."""
    ref = ref_cls(**kwargs)
    ref.persistent(True)
    for seed in (17, 18):
        preds, target = _inputs(task, "probs", None, seed)
        ref.update(_j(preds), _j(target))
    port = load_reference_state(port_cls(device="cpu", **kwargs), ref.state_dict())
    assert port.update_count == 2
    exact = port_cls is tc.MulticlassROC
    _assert_same(port.compute(), ref.compute(), exact=exact)
    preds, target = _inputs(task, "probs", None, 19)
    port.update(_t(preds), _t(target))
    ref.update(_j(preds), _j(target))
    _assert_same(port.compute(), ref.compute(), exact=exact)


def test_curve_family_argument_validation():
    with pytest.raises(ValueError, match="num_labels"):
        tc.MultilabelPrecisionRecallCurve(num_labels=1, device="cpu")
    with pytest.raises(ValueError, match="max_fpr"):
        tc.BinaryAUROC(max_fpr=1.5, device="cpu")
    with pytest.raises(ValueError, match="average"):
        tc.MulticlassAveragePrecision(num_classes=3, average="micro", device="cpu")
    with pytest.raises(ValueError, match="fpr_range"):
        tc.BinaryLogAUC(fpr_range=(0.5, 0.1), device="cpu")
    with pytest.raises(ValueError, match="min_recall"):
        tc.BinaryPrecisionAtFixedRecall(min_recall=2.0, device="cpu")
    with pytest.raises(RuntimeError, match="Detected the following values"):
        tf.multilabel_average_precision(torch.rand(4, 2), torch.tensor([[0, 1], [2, 1], [0, 0], [1, 1]]), num_labels=2)
    with pytest.raises(ValueError, match="num_labels"):
        tc.AUROC(task="multilabel", device="cpu")
    assert isinstance(tc.PrecisionRecallCurve(task="multilabel", num_labels=3, device="cpu"),
                      tc.MultilabelPrecisionRecallCurve)
