"""Calibration error, the three multilabel ranking metrics and hinge loss: the port against the JAX package,
functional and class, for every task and option the JAX package takes, with confidences on the bin
edges, rows with every label or no label relevant, tied scores, and the state carried over from a JAX
metric; inputs and tolerances as ``tests/test_torch_stat_cases.py`` sets them out (calibration error and
hinge loss within rtol 1e-5, atol 1e-6)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu_torch.classification as tc
from metrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds
from metrics_tpu_torch.interop import load_reference_state
from tests.test_torch_stat_cases import (
    C,
    N,
    SUM_ATOL,
    SUM_RTOL,
    TASK_CLS,
    TASK_FN,
    assert_same,
    inputs,
    run_class,
    run_functional,
    task_args,
)


def _check(fn, cls, task, batches, args, rtol=SUM_RTOL, atol=SUM_ATOL):
    args = {**task_args(task), **args}
    run_functional(TASK_FN[task] + fn, *batches[0], args, rtol, atol)
    run_class(TASK_CLS[task] + cls, batches, args, rtol, atol)


# ----------------------------------------------------------------------------- calibration error
def _on_edges(task, n_bins, seed, ignore_index=None):
    """Scores of which a third lie exactly on the JAX package's bin boundaries."""
    preds, target = inputs(task, "probs", ignore_index, seed)
    rng = np.random.RandomState(seed + 100)
    edges = _linspace_thresholds(n_bins + 1, torch.float32)
    on = edges[rng.randint(0, n_bins + 1, preds.shape)]
    preds = np.where(rng.rand(*preds.shape) < 0.33, on, preds).astype(np.float32)
    if task == "multiclass":  # rows that stay probability vectors, with top scores on edges
        preds = preds / preds.sum(1, keepdims=True)
        top = rng.randint(0, C, N)
        preds[np.arange(N), top] = np.maximum(preds[np.arange(N), top], edges[rng.randint(n_bins // 2, n_bins, N)])
    return preds, target


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("n_bins", [3, 10, 15])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_calibration_error_with_confidences_on_bin_edges(task, norm, n_bins, ignore_index):
    batches = [_on_edges(task, n_bins, seed, ignore_index) for seed in (1, 2)]
    _check("calibration_error", "CalibrationError", task, batches,
           {"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index})


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_calibration_error_from_logits_and_task_wrapper(task, norm):
    batches = [inputs(task, "logits", None, seed) for seed in (3, 4)]
    args = {"n_bins": 15, "norm": norm, **task_args(task)}
    run_functional("calibration_error", *batches[0], {"task": task, **args}, SUM_RTOL, SUM_ATOL)
    run_class("CalibrationError", batches, args, SUM_RTOL, SUM_ATOL, wrapper_task=task)


# ----------------------------------------------------------------------------- ranking
RANKING = [("coverage_error", "CoverageError"), ("ranking_average_precision", "RankingAveragePrecision"),
           ("ranking_loss", "RankingLoss")]


def _ranking_inputs(seed, ignore_index=None, ties=False):
    """Multilabel scores and targets with a row of every label relevant and a row of none."""
    preds, target = inputs("multilabel", "probs", ignore_index, seed)
    if ties:
        preds = (np.round(preds * 4) / 4).astype(np.float32)
    target[0] = 1
    target[1] = 0
    return preds, target


@pytest.mark.parametrize(("fn", "cls"), RANKING)
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("ties", [False, True])
def test_ranking(fn, cls, ignore_index, ties):
    batches = [_ranking_inputs(seed, ignore_index, ties) for seed in (5, 6)]
    _check(fn, cls, "multilabel", batches, {"ignore_index": ignore_index}, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(("fn", "cls"), RANKING)
@pytest.mark.parametrize("case", ["all_relevant", "none_relevant", "logits"])
def test_ranking_extremes(fn, cls, case):
    """Every row with all labels relevant, or none (the score is then 1 or 0 per row), and logits below 0
    (coverage error offsets by the batch's minimum)."""
    preds, target = inputs("multilabel", "logits", None, 7)
    if case != "logits":
        target = np.full_like(target, 1 if case == "all_relevant" else 0)
    _check(fn, cls, "multilabel", [(preds, target)] * 2, {}, rtol=1e-6, atol=1e-7)


def test_ranking_validation_matches_reference():
    for cls in ("MultilabelCoverageError", "MultilabelRankingAveragePrecision", "MultilabelRankingLoss"):
        with pytest.raises(ValueError) as port:
            getattr(tc, cls)(num_labels=1, device="cpu")
        with pytest.raises(ValueError) as ref:
            getattr(jc, cls)(num_labels=1)
        assert str(port.value) == str(ref.value)
    preds, target = inputs("multilabel", "labels", None, 8)
    import metrics_tpu.functional.classification as jf
    import metrics_tpu_torch.functional.classification as tf

    with pytest.raises(ValueError) as port:
        tf.multilabel_ranking_loss(torch.from_numpy(preds), torch.from_numpy(target), num_labels=C)
    with pytest.raises(ValueError) as ref:
        jf.multilabel_ranking_loss(jnp.asarray(preds), jnp.asarray(target), num_labels=C)
    assert str(port.value).split(" dtype")[0] == str(ref.value).split(" dtype")[0]


# ----------------------------------------------------------------------------- hinge
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_hinge(squared, kind, ignore_index):
    batches = [inputs("binary", kind, ignore_index, seed) for seed in (9, 10)]
    _check("hinge_loss", "HingeLoss", "binary", batches, {"squared": squared, "ignore_index": ignore_index})


@pytest.mark.parametrize("mode", ["crammer-singer", "one-vs-all"])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_hinge(mode, squared, kind, ignore_index):
    """Crammer-Singer's margin against the best other class (the target masked with -inf); one-vs-all's
    measure per class."""
    batches = [inputs("multiclass", kind, ignore_index, seed) for seed in (11, 12)]
    _check("hinge_loss", "HingeLoss", "multiclass", batches,
           {"squared": squared, "multiclass_mode": mode, "ignore_index": ignore_index})


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_hinge_task_wrapper(task):
    batches = [inputs(task, "logits", None, seed) for seed in (13, 14)]
    args = {"squared": True, **task_args(task)}
    if task == "multiclass":
        args["multiclass_mode"] = "one-vs-all"
    run_functional("hinge_loss", *batches[0], {"task": task, **args}, SUM_RTOL, SUM_ATOL)
    run_class("HingeLoss", batches, args, SUM_RTOL, SUM_ATOL, wrapper_task=task)


def test_hinge_validation_matches_reference():
    for cls, args in (("BinaryHingeLoss", {"squared": 1}), ("MulticlassHingeLoss", {"num_classes": C,
                                                                                     "multiclass_mode": "ova"})):
        with pytest.raises(ValueError) as port:
            getattr(tc, cls)(device="cpu", **args)
        with pytest.raises(ValueError) as ref:
            getattr(jc, cls)(**args)
        assert str(port.value) == str(ref.value)


# ----------------------------------------------------------------------------- state from the JAX package
@pytest.mark.parametrize(("cls", "args", "make"), [
    ("MulticlassCalibrationError", {"num_classes": C, "n_bins": 10}, lambda s: inputs("multiclass", "probs", -1, s)),
    ("BinaryCalibrationError", {"norm": "max", "ignore_index": -1}, lambda s: inputs("binary", "probs", -1, s)),
    ("MultilabelRankingLoss", {"num_labels": C}, lambda s: _ranking_inputs(s)),
    ("MultilabelCoverageError", {"num_labels": C}, lambda s: _ranking_inputs(s)),
    ("MulticlassHingeLoss", {"num_classes": C, "multiclass_mode": "one-vs-all"},
     lambda s: inputs("multiclass", "logits", None, s)),
    ("BinaryHingeLoss", {"squared": True}, lambda s: inputs("binary", "logits", None, s)),
])
def test_state_carried_from_reference(cls, args, make):
    """A JAX metric's ``state_dict()`` (the calibration ``cat`` lists, the ranking and hinge sums) installed
    into the port's metric, which then goes on updating and computes what the JAX metric computes."""
    if "ignore_index" not in args and cls.startswith("MulticlassCalibration"):
        args = {**args, "ignore_index": -1}
    ref = getattr(jc, cls)(**args)
    ref.persistent(True)
    first, second = make(30), make(31)
    ref.update(jnp.asarray(first[0]), jnp.asarray(first[1]))
    port = load_reference_state(getattr(tc, cls)(device="cpu", **args), ref.state_dict())
    ref.update(jnp.asarray(second[0]), jnp.asarray(second[1]))
    port.update(torch.from_numpy(np.array(second[0])), torch.from_numpy(np.array(second[1])))
    assert port.update_count == 2
    assert_same(port.compute(), ref.compute(), SUM_RTOL, SUM_ATOL)
