"""Precision, recall, F-beta, F1, specificity, negative predictive value and Hamming distance: the port
against the JAX package, functional and class, for every task, average, ``multidim_average``, ``top_k``,
``ignore_index`` and ``zero_division`` the JAX package takes; inputs and tolerances as
``tests/test_torch_stat_cases.py`` sets them out."""

from __future__ import annotations

import inspect

import numpy as np
import pytest

import metrics_tpu.functional.classification as jf
from tests.test_torch_stat_cases import C, N, TASK_CLS, TASK_FN, inputs, run_class, run_functional, task_args

# family -> (functional stem, class stem, extra arguments)
FAMILIES = {
    "precision": ("precision", "Precision", {}),
    "recall": ("recall", "Recall", {}),
    "fbeta": ("fbeta_score", "FBetaScore", {"beta": 2.0}),
    "f1": ("f1_score", "F1Score", {}),
    "specificity": ("specificity", "Specificity", {}),
    "npv": ("negative_predictive_value", "NegativePredictiveValue", {}),
    "hamming": ("hamming_distance", "HammingDistance", {}),
}
WITH_ZERO_DIVISION = [f for f, (stem, _, _) in FAMILIES.items()
                      if "zero_division" in inspect.signature(getattr(jf, "binary_" + stem)).parameters]


def _check(family, task, batches, args):
    stem, cls, extra = FAMILIES[family]
    args = {**extra, **task_args(task), **args}
    run_functional(TASK_FN[task] + stem, *batches[0], args)
    run_class(TASK_CLS[task] + cls, batches, args)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary(family, kind, multidim_average, ignore_index):
    samplewise = multidim_average == "samplewise"
    batches = [inputs("binary", kind, ignore_index, seed, samplewise) for seed in (1, 2)]
    _check(family, "binary", batches, {"multidim_average": multidim_average, "ignore_index": ignore_index})


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ["probs", "labels"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, 1])
def test_multiclass(family, kind, average, ignore_index):
    batches = [inputs("multiclass", kind, ignore_index, seed) for seed in (3, 4)]
    _check(family, "multiclass", batches, {"average": average, "ignore_index": ignore_index})


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("average", ["micro", "macro", "none"])
def test_multiclass_samplewise(family, average):
    batches = [inputs("multiclass", "logits", -1, seed, samplewise=True) for seed in (5, 6)]
    _check(family, "multiclass", batches, {"average": average, "multidim_average": "samplewise",
                                           "ignore_index": -1})


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("top_k", [2, 3])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted"])
def test_multiclass_top_k_with_ties(family, top_k, average):
    """Scores on a grid of quarters tie often; both packages break ties toward the lower class."""
    batches = []
    for seed in (7, 8):
        rng = np.random.RandomState(seed)
        batches.append(((rng.randint(0, 4, (N, C)) / 4).astype(np.float32), rng.randint(0, C, N)))
    _check(family, "multiclass", batches, {"average": average, "top_k": top_k, "ignore_index": 0})


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel(family, average, ignore_index):
    batches = [inputs("multilabel", "probs", ignore_index, seed) for seed in (9, 10)]
    _check(family, "multilabel", batches, {"average": average, "ignore_index": ignore_index})


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("average", ["micro", "macro"])
def test_multilabel_samplewise(family, average):
    batches = [inputs("multilabel", "logits", None, seed, samplewise=True) for seed in (11, 12)]
    _check(family, "multilabel", batches, {"average": average, "multidim_average": "samplewise"})


@pytest.mark.parametrize("family", WITH_ZERO_DIVISION)
@pytest.mark.parametrize("zero_division", [0, 1])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_zero_division_on_absent_classes(family, zero_division, task):
    """Targets and predictions that leave some classes (and the binary positives) empty, so that some
    denominators are 0."""
    rng = np.random.RandomState(13)
    if task == "binary":
        batches = [(np.zeros(N, np.int64), np.zeros(N, np.int64)), (rng.randint(0, 2, N), np.zeros(N, np.int64))]
    elif task == "multiclass":
        batches = [(rng.randint(0, 2, N), rng.randint(0, 2, N)) for _ in range(2)]
    else:
        batches = [(np.zeros((N, C), np.int64), np.concatenate([np.zeros((N, 2), np.int64),
                                                                rng.randint(0, 2, (N, 2))], 1)) for _ in range(2)]
    args = {"zero_division": zero_division}
    if task != "binary":
        args["average"] = "macro"
    _check(family, task, batches, args)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_task_wrappers(family, task):
    """The dispatching function and the task wrapper class, with the dispatchers' own default average."""
    stem, cls, extra = FAMILIES[family]
    preds, target = inputs(task, "probs", None, 14)
    args = {"task": task, **extra, **task_args(task)}
    run_functional(stem, preds, target, args)
    run_class(cls, [(preds, target), inputs(task, "probs", None, 15)], {**extra, **task_args(task)},
              wrapper_task=task)


@pytest.mark.parametrize("family", FAMILIES)
def test_argument_validation_matches_reference(family):
    stem, cls, extra = FAMILIES[family]
    import metrics_tpu.classification as jc
    import metrics_tpu_torch.classification as tc
    import metrics_tpu_torch.functional.classification as tf

    bad = [("binary", {"threshold": 2.0}), ("multiclass", {"num_classes": 1}), ("multiclass", {"top_k": 0}),
           ("multiclass", {"average": "mean"}), ("multilabel", {"num_labels": 1}),
           ("binary", {"multidim_average": "per-row"})]
    if family == "fbeta":
        bad.append(("binary", {"beta": -1.0}))
    for task, args in bad:
        args = {**extra, **task_args(task), **args}
        # the same error, or none in both (the F-beta classes check only beta, as in the JAX package)
        assert _error(lambda: getattr(tc, TASK_CLS[task] + cls)(device="cpu", **args)) == \
            _error(lambda: getattr(jc, TASK_CLS[task] + cls)(**args)), args
        assert _error(lambda: getattr(tf, TASK_FN[task] + stem)(*_tensors(task), **args)) == \
            _error(lambda: getattr(jf, TASK_FN[task] + stem)(*_arrays(task), **args)), args
    preds, target = inputs("binary", "probs", None, 0)
    with pytest.raises(RuntimeError) as port_err:
        getattr(tf, "binary_" + stem)(_tensor(preds), _tensor(target + 2), **extra)
    with pytest.raises(RuntimeError) as ref_err:
        getattr(jf, "binary_" + stem)(_array(preds), _array(target + 2), **extra)
    assert str(port_err.value).split(":")[0] == str(ref_err.value).split(":")[0]


def _error(make):
    try:
        make()
    except ValueError as err:
        return str(err)
    return None


def _tensors(task):
    return [_tensor(x) for x in inputs(task, "probs", None, 0)]


def _arrays(task):
    return [_array(x) for x in inputs(task, "probs", None, 0)]


def _tensor(x):
    import torch

    return torch.from_numpy(np.array(x))


def _array(x):
    import jax.numpy as jnp

    return jnp.asarray(np.array(x))
