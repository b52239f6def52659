"""Shared cases and comparisons of the curve-family parity tests (``tests/test_torch_curves*.py``); no tests here.

The port's binned curve family against the JAX package's, on the same seeded inputs.

Families: precision-recall curve, ROC, AUROC, average precision, LogAUC and
the four fixed-point metrics (sensitivity at specificity, specificity at
sensitivity, precision at fixed recall, recall at fixed precision), each for
the binary, multiclass and multilabel task, as a function and as a class fed
two updates. The port runs on the CPU through the binned-counts kernel's plain
version; the JAX package runs on the CPU as its own tests run it.

Tolerances:

* binned confusion states: integer-equal;
* curves that are quotients of counts (every PR and ROC curve but the
  ``macro`` average) and the fixed-point values and thresholds: equal, bit for
  bit;
* interpolated curves (``macro`` averages) and reduced scores (AUROC, AP,
  LogAUC): rtol 1e-5, atol 1e-6, since they are float32 sums of up to T + 1
  trapezoids or steps, taken in another order;
* with logits, the scores go through a sigmoid or softmax whose float32 results
  differ by an ulp or so between PyTorch and XLA; on the exact path
  (``thresholds=None``) the thresholds are those scores, so there every output
  is held within rtol 1e-6 instead of bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

import metrics_tpu.classification as jc
import metrics_tpu.functional.classification as jf
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional.classification as tf

N = 48
C = 4
RTOL, ATOL = 1e-5, 1e-6
SCORE_RTOL = 1e-6

# family -> (functional stem, class stem, extra arguments, what it returns)
FAMILIES = {
    "prc": ("precision_recall_curve", "PrecisionRecallCurve", {}, "curve"),
    "roc": ("roc", "ROC", {}, "curve"),
    "auroc": ("auroc", "AUROC", {}, "score"),
    "ap": ("average_precision", "AveragePrecision", {}, "score"),
    "logauc": ("logauc", "LogAUC", {}, "score"),
    "sens_at_spec": ("sensitivity_at_specificity", "SensitivityAtSpecificity", {"min_specificity": 0.5}, "fixed"),
    "spec_at_sens": ("specificity_at_sensitivity", "SpecificityAtSensitivity", {"min_sensitivity": 0.5}, "fixed"),
    "prec_at_rec": ("precision_at_fixed_recall", "PrecisionAtFixedRecall", {"min_recall": 0.5}, "fixed"),
    "rec_at_prec": ("recall_at_fixed_precision", "RecallAtFixedPrecision", {"min_precision": 0.5}, "fixed"),
}
TASK_PREFIX = {"binary": ("binary_", "Binary"), "multiclass": ("multiclass_", "Multiclass"),
               "multilabel": ("multilabel_", "Multilabel")}
THRESHOLDS = [None, 7, [0.1, 0.5, 0.5, 0.9, 0.3], "tensor"]
THRESHOLD_IDS = ["exact", "int", "list-unsorted-ties", "tensor-unsorted"]
TENSOR_THRESHOLDS = np.array([0.7, 0.2, 0.9, 0.2, 0.0, 0.45], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.array(x))


def _thresholds(thresholds):
    if isinstance(thresholds, str):
        return _t(TENSOR_THRESHOLDS), _j(TENSOR_THRESHOLDS)
    return thresholds, thresholds


def _scores(rng, shape, kind):
    """Half uniform float32 scores, half on a grid of eighths (ties, and scores on thresholds), or logits."""
    if kind == "logits":
        return (rng.randn(*shape) * 3).astype(np.float32)
    fine = rng.rand(*shape).astype(np.float32)
    coarse = (rng.randint(0, 9, shape) / 8).astype(np.float32)
    return np.where(rng.rand(*shape) < 0.5, fine, coarse)


def _inputs(task, kind, ignore_index, seed):
    rng = np.random.RandomState(seed)
    if task == "binary":
        preds, target = _scores(rng, (N,), kind), rng.randint(0, 2, N)
    elif task == "multiclass":
        preds, target = _scores(rng, (N, C), kind), rng.randint(0, C, N)
    else:
        preds, target = _scores(rng, (N, C), kind), rng.randint(0, 2, (N, C))
    if ignore_index is not None:
        target = np.where(rng.rand(*target.shape) < 0.2, ignore_index, target)
    return preds, target


def _task_args(task):
    return {"num_classes": C} if task == "multiclass" else {"num_labels": C} if task == "multilabel" else {}


def _assert_same(port, ref, exact, rtol=RTOL, atol=ATOL, check_dtype=True):
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref), (type(port), type(ref))
        for p, r in zip(port, ref):
            _assert_same(p, r, exact, rtol, atol, check_dtype)
        return
    assert isinstance(port, torch.Tensor)
    port_np, ref_np = port.cpu().numpy(), np.asarray(ref)
    assert port_np.shape == ref_np.shape
    if check_dtype:
        assert str(port.dtype).replace("torch.", "") == str(ref_np.dtype), (port.dtype, ref_np.dtype)
    if exact:
        np.testing.assert_array_equal(port_np, ref_np)
    else:
        np.testing.assert_allclose(port_np.astype(np.float64), ref_np.astype(np.float64), rtol=rtol, atol=atol)


def _is_exact(family, average, thresholds, kind):
    returns = FAMILIES[family][3]
    if kind == "logits" and thresholds is None and returns != "score":
        return None  # the thresholds are scores that went through a sigmoid or softmax
    if returns == "fixed":
        return True
    return returns == "curve" and average != "macro"


def _compare(port, ref, family, average, thresholds, kind):
    exact = _is_exact(family, average, thresholds, kind)
    if exact is None:
        _assert_same(port, ref, False, rtol=SCORE_RTOL, atol=0)
    else:
        _assert_same(port, ref, exact)


def _run_functional(family, task, preds, target, thresholds, ignore_index, extra):
    stem = FAMILIES[family][0]
    prefix = TASK_PREFIX[task][0]
    t_thr, j_thr = _thresholds(thresholds)
    args = dict(thresholds=None, ignore_index=ignore_index, **_task_args(task), **extra)
    port = getattr(tf, prefix + stem)(_t(preds), _t(target), **{**args, "thresholds": t_thr})
    ref = getattr(jf, prefix + stem)(_j(preds), _j(target), **{**args, "thresholds": j_thr})
    return port, ref


def _run_class(family, task, batches, thresholds, ignore_index, extra, via_wrapper=False):
    stem = FAMILIES[family][1]
    t_thr, j_thr = _thresholds(thresholds)
    args = dict(ignore_index=ignore_index, **_task_args(task), **extra)
    if via_wrapper:
        port = getattr(tc, stem)(task=task, thresholds=t_thr, device="cpu", **args)
        ref = getattr(jc, stem)(task=task, thresholds=j_thr, **args)
    else:
        name = TASK_PREFIX[task][1] + stem
        port = getattr(tc, name)(thresholds=t_thr, device="cpu", **args)
        ref = getattr(jc, name)(thresholds=j_thr, **args)
    for preds, target in batches:
        port.update(_t(preds), _t(target))
        ref.update(_j(preds), _j(target))
    if thresholds is not None:
        # int64 counters in the port, int32 in the JAX package: values, not dtypes, are compared
        _assert_same(port.confmat, ref.confmat, exact=True, check_dtype=False)
    return port, ref


def check_family(family, task, thresholds, ignore_index, kind):
    """The functional on one batch, then the class (through its task wrapper for multiclass and multilabel)
    on two, against the JAX package's."""
    extra = FAMILIES[family][2]
    preds, target = _inputs(task, kind, ignore_index, seed=1)
    port, ref = _run_functional(family, task, preds, target, thresholds, ignore_index, extra)
    _compare(port, ref, family, None, thresholds, kind)

    batches = [_inputs(task, kind, ignore_index, seed=s) for s in (2, 3)]
    port, ref = _run_class(family, task, batches, thresholds, ignore_index, extra, via_wrapper=task != "binary")
    _compare(port.compute(), ref.compute(), family, None, thresholds, kind)
