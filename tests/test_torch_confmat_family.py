"""The confusion matrix and what builds on it (Jaccard index, Cohen's kappa, Matthews correlation), exact
match and the legacy Dice: the port against the JAX package, functional and class, for every task and
option the JAX package takes, with the degenerate inputs each has (a single class, every sample right or
wrong, tied scores), and the state carried over from a JAX metric; inputs and tolerances as
``tests/test_torch_stat_cases.py`` sets them out."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu_torch.classification as tc
from metrics_tpu_torch.interop import load_reference_state
from tests.test_torch_stat_cases import (
    ATOL,
    C,
    N,
    S,
    TASK_CLS,
    TASK_FN,
    assert_same,
    inputs,
    run_class,
    run_functional,
    task_args,
)

TASKS = ["binary", "multiclass", "multilabel"]


# Cohen's kappa is 1 - k, k a float32 quotient of sums of expected counts taken in another order than the
# JAX package's: an ulp of k (about 1.2e-7 near 1) is what the two may differ by, whatever kappa's size
KAPPA_ATOL = 1e-6


def _check(fn, cls, task, batches, args, atol=ATOL):
    args = {**task_args(task), **args}
    run_functional(TASK_FN[task] + fn, *batches[0], args, atol=atol)
    run_class(TASK_CLS[task] + cls, batches, args, atol=atol)


# ----------------------------------------------------------------------------- confusion matrix
@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("normalize", [None, "true", "pred", "all", "none"])
@pytest.mark.parametrize("ignore_index", [None, 1, -1])
def test_confusion_matrix(task, normalize, ignore_index):
    if task != "multiclass" and ignore_index == 1:
        ignore_index = 0  # a label of the binary and multilabel targets
    kind = "logits" if task == "multilabel" else "probs"
    batches = [inputs(task, kind, ignore_index, seed) for seed in (1, 2)]
    _check("confusion_matrix", "ConfusionMatrix", task, batches, {"normalize": normalize,
                                                                  "ignore_index": ignore_index})


@pytest.mark.parametrize("task", TASKS)
def test_confusion_matrix_from_labels_and_extra_dims(task):
    batches = [inputs(task, "labels", None, seed, samplewise=True) for seed in (3, 4)]
    _check("confusion_matrix", "ConfusionMatrix", task, batches, {})
    run_functional("confusion_matrix", *batches[0], {"task": task, **task_args(task)})
    run_class("ConfusionMatrix", batches, task_args(task), wrapper_task=task)


# ----------------------------------------------------------------------------- exact match
@pytest.mark.parametrize("task", ["multiclass", "multilabel"])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_exact_match(task, multidim_average, ignore_index):
    """Samplewise, one update: the JAX package's samplewise state cannot take a second (its per-update
    totals do not broadcast against the per-sample counts)."""
    rng = np.random.RandomState(5)
    batches = []
    for seed in (5, 6):
        preds, target = inputs(task, "labels", ignore_index, seed, samplewise=True)
        if task == "multiclass":  # mostly right, so that some rows match exactly
            preds = np.where(rng.rand(*target.shape) < 0.8, np.maximum(target, 0), preds)
        batches.append((preds, target))
    if multidim_average == "samplewise":
        batches = batches[:1]
    args = {"multidim_average": multidim_average, "ignore_index": ignore_index}
    _check("exact_match", "ExactMatch", task, batches, args)
    run_functional("exact_match", *batches[0], {"task": task, **task_args(task), **args})
    run_class("ExactMatch", batches, {**task_args(task), **args}, wrapper_task=task)


# ----------------------------------------------------------------------------- jaccard
@pytest.mark.parametrize("task", ["multiclass", "multilabel"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, 0, -1])
def test_jaccard(task, average, ignore_index):
    batches = [inputs(task, "probs", ignore_index, seed) for seed in (7, 8)]
    _check("jaccard_index", "JaccardIndex", task, batches, {"average": average, "ignore_index": ignore_index})


@pytest.mark.parametrize("zero_division", [0.0, 1.0])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_jaccard_and_zero_division(zero_division, ignore_index):
    batches = [inputs("binary", "probs", ignore_index, seed) for seed in (9, 10)]
    _check("jaccard_index", "JaccardIndex", "binary", batches, {"zero_division": zero_division,
                                                                "ignore_index": ignore_index})
    empty = [(np.zeros(N, np.int64), np.zeros(N, np.int64))] * 2  # no positive predicted or present: 0 / 0
    _check("jaccard_index", "JaccardIndex", "binary", empty, {"zero_division": zero_division})
    absent = [(np.random.RandomState(11).randint(0, 2, N), np.random.RandomState(12).randint(0, 2, N))] * 2
    _check("jaccard_index", "JaccardIndex", "multiclass", absent, {"average": "none",
                                                                   "zero_division": zero_division})


@pytest.mark.parametrize("task", TASKS)
def test_jaccard_task_wrapper(task):
    batches = [inputs(task, "probs", None, seed) for seed in (13, 14)]
    run_functional("jaccard_index", *batches[0], {"task": task, **task_args(task)})
    run_class("JaccardIndex", batches, task_args(task), wrapper_task=task)


# ----------------------------------------------------------------------------- cohen's kappa
@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_cohen_kappa(task, weights, ignore_index):
    batches = [inputs(task, "logits", ignore_index, seed) for seed in (15, 16)]
    _check("cohen_kappa", "CohenKappa", task, batches, {"weights": weights, "ignore_index": ignore_index},
           atol=KAPPA_ATOL)
    args = {"weights": weights, "ignore_index": ignore_index, **task_args(task)}
    run_functional("cohen_kappa", *batches[0], {"task": task, **args}, atol=KAPPA_ATOL)
    run_class("CohenKappa", batches, args, atol=KAPPA_ATOL, wrapper_task=task)


def _degenerate(task, case):
    """Labels where every sample is one class, every prediction right, or every prediction wrong."""
    rng = np.random.RandomState(17)
    k = 2 if task == "binary" else C
    shape = (N, C) if task == "multilabel" else (N,)
    target = rng.randint(0, 2 if task != "multiclass" else C, shape)
    if case == "one_class":
        return np.zeros(shape, np.int64), np.zeros(shape, np.int64)
    if case == "one_class_target":
        return rng.randint(0, 2 if task != "multiclass" else C, shape), np.ones(shape, np.int64)
    if case == "all_right":
        return target.copy(), target
    return (target + 1) % k, target  # all wrong


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("case", ["one_class", "one_class_target", "all_right", "all_wrong"])
@pytest.mark.parametrize("weights", [None, "quadratic"])
def test_cohen_kappa_degenerate(task, case, weights):
    preds, target = _degenerate(task, case)
    _check("cohen_kappa", "CohenKappa", task, [(preds, target)] * 2, {"weights": weights}, atol=KAPPA_ATOL)


# ----------------------------------------------------------------------------- matthews
@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_matthews_corrcoef(task, ignore_index):
    batches = [inputs(task, "probs", ignore_index, seed) for seed in (18, 19)]
    _check("matthews_corrcoef", "MatthewsCorrCoef", task, batches, {"ignore_index": ignore_index})
    args = {"ignore_index": ignore_index, **task_args(task)}
    run_functional("matthews_corrcoef", *batches[0], {"task": task, **args})
    run_class("MatthewsCorrCoef", batches, args, wrapper_task=task)


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("case", ["one_class", "one_class_target", "all_right", "all_wrong"])
def test_matthews_corrcoef_degenerate(task, case):
    """The binary degenerate branches (a collapsed row or column) and the general formula's zero
    denominator."""
    preds, target = _degenerate(task, case)
    _check("matthews_corrcoef", "MatthewsCorrCoef", task, [(preds, target)] * 2, {})


# ----------------------------------------------------------------------------- dice
DICE_INPUTS = ["labels", "binary_probs", "multilabel_probs", "multiclass_probs", "multiclass_ties"]


def _dice_inputs(kind, seed, samplewise=False):
    rng = np.random.RandomState(seed)
    extra = (S,) if samplewise else ()
    if kind == "labels":
        return rng.randint(0, C, (N, *extra)), rng.randint(0, C, (N, *extra))
    if kind == "binary_probs":
        return rng.rand(N).astype(np.float32), rng.randint(0, 2, N)
    if kind == "multilabel_probs":
        return rng.rand(N, C, *extra).astype(np.float32), rng.randint(0, 2, (N, C, *extra))
    scores = rng.rand(N, C, *extra) if kind == "multiclass_probs" else rng.randint(0, 3, (N, C, *extra)) / 2
    return scores.astype(np.float32), rng.randint(0, C, (N, *extra))


@pytest.mark.parametrize("kind", DICE_INPUTS)
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none", "samples"])
@pytest.mark.parametrize("mdmc_average", ["global", "samplewise"])
def test_dice(kind, average, mdmc_average):
    """Tied multiclass scores take the top k by a stable rank: ties to the lower class, as in JAX."""
    samplewise = mdmc_average == "samplewise" and kind in ("labels", "multilabel_probs", "multiclass_ties")
    batches = [_dice_inputs(kind, seed, samplewise) for seed in (20, 21)]
    num_classes = 1 if kind == "binary_probs" else C
    args = {"average": average, "mdmc_average": mdmc_average, "num_classes": num_classes}
    if kind == "multiclass_ties":
        args["top_k"] = 2
    run_functional("dice", *batches[0], args)
    run_class("Dice", batches, args)


@pytest.mark.parametrize("kind", ["labels", "multiclass_ties"])
@pytest.mark.parametrize("ignore_index", [0, 2])
@pytest.mark.parametrize("zero_division", [0, 1])
def test_dice_ignore_index_and_zero_division(kind, ignore_index, zero_division):
    batches = [_dice_inputs(kind, seed) for seed in (22, 23)]
    for average in ("micro", "macro", "none"):
        args = {"average": average, "num_classes": C, "ignore_index": ignore_index,
                "zero_division": zero_division}
        if kind == "multiclass_ties":
            args["top_k"] = 3
        run_functional("dice", *batches[0], args)
        run_class("Dice", batches, args)


def test_dice_top_k_on_tied_scores_is_stable():
    """Every score tied: the top 2 are classes 0 and 1 in both packages."""
    preds = np.full((N, C), 0.25, np.float32)
    target = np.random.RandomState(24).randint(0, C, N)
    port, _ = run_functional("dice", preds, target, {"average": "none", "num_classes": C, "top_k": 2})
    want = np.zeros(C, np.float32)
    for c in (0, 1):
        tp = (target == c).sum()
        want[c] = 2 * tp / (2 * tp + (N - tp))
    np.testing.assert_allclose(port.numpy(), want, rtol=1e-6)


# ----------------------------------------------------------------------------- validation
@pytest.mark.parametrize(("cls", "task", "args"), [
    ("ConfusionMatrix", "binary", {"normalize": "rows"}), ("ConfusionMatrix", "multiclass", {"num_classes": 1}),
    ("JaccardIndex", "multiclass", {"average": "samples"}), ("CohenKappa", "binary", {"weights": "cubic"}),
    ("MatthewsCorrCoef", "multilabel", {"num_labels": 1}), ("ExactMatch", "multiclass", {"ignore_index": 0.5}),
])
def test_argument_validation_matches_reference(cls, task, args):
    def error(make):
        try:
            make()
        except ValueError as err:
            return str(err)
        return None

    args = {**task_args(task), **args}
    port = error(lambda: getattr(tc, TASK_CLS[task] + cls)(device="cpu", **args))
    ref = error(lambda: getattr(jc, TASK_CLS[task] + cls)(**args))
    assert port == ref and port is not None


def test_dice_validation_matches_reference():
    for args in ({"average": "median"}, {"mdmc_average": "rows"}, {"average": "macro"},
                 {"num_classes": 3, "ignore_index": 5}):
        with pytest.raises(ValueError) as port:
            tc.Dice(device="cpu", **args)
        with pytest.raises(ValueError) as ref:
            jc.Dice(**args)
        assert str(port.value) == str(ref.value)


# ----------------------------------------------------------------------------- state from the JAX package
@pytest.mark.parametrize(("cls", "args", "make"), [
    ("MulticlassConfusionMatrix", {"num_classes": C}, lambda s: inputs("multiclass", "probs", None, s)),
    ("MultilabelJaccardIndex", {"num_labels": C}, lambda s: inputs("multilabel", "probs", None, s)),
    ("BinaryCohenKappa", {"weights": "linear"}, lambda s: inputs("binary", "logits", None, s)),
    ("MulticlassMatthewsCorrCoef", {"num_classes": C}, lambda s: inputs("multiclass", "labels", None, s)),
    ("MultilabelExactMatch", {"num_labels": C}, lambda s: inputs("multilabel", "probs", None, s, True)),
    ("MulticlassExactMatch", {"num_classes": C, "multidim_average": "samplewise"},
     lambda s: inputs("multiclass", "labels", None, s, True)),
    ("Dice", {"average": "macro", "num_classes": C}, lambda s: _dice_inputs("labels", s)),
    ("Dice", {"average": "samples"}, lambda s: _dice_inputs("multilabel_probs", s)),
    ("MulticlassF1Score", {"num_classes": C, "average": "weighted"}, lambda s: inputs("multiclass", "probs", None, s)),
    ("MultilabelPrecision", {"num_labels": C, "multidim_average": "samplewise"},
     lambda s: inputs("multilabel", "probs", None, s, True)),
])
def test_state_carried_from_reference(cls, args, make):
    """A JAX metric's ``state_dict()`` installed into the port's metric, which then goes on updating and
    computes what the JAX metric computes."""
    ref = getattr(jc, cls)(**args)
    ref.persistent(True)
    first, second = make(30), make(31)
    ref.update(jnp.asarray(first[0]), jnp.asarray(first[1]))
    port = load_reference_state(getattr(tc, cls)(device="cpu", **args), ref.state_dict())
    assert port.update_count == 1
    if "samplewise" not in args.values():
        ref.update(jnp.asarray(second[0]), jnp.asarray(second[1]))
        port.update(torch.from_numpy(np.array(second[0])), torch.from_numpy(np.array(second[1])))
    assert_same(port.compute(), ref.compute())
