"""The stat-score and confusion-matrix family in the float64 regime: torch's default dtype float64 against
the JAX package under x64, functional and class, with the same values in the same dtypes. Scores that the
JAX package casts to float32 whatever the regime (normalized confusion matrices, Jaccard, Matthews, the
weighted kappa, ranking average precision, the multiclass calibration error, Dice) stay float32; the ones
that divide int64 counters or add Python floats follow the default dtype. Inputs and tolerances as
``tests/test_torch_stat_cases.py`` sets them out."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_stat_cases import (
    SUM_ATOL,
    SUM_RTOL,
    TASK_CLS,
    TASK_FN,
    inputs,
    run_class,
    run_functional,
    task_args,
)

# (functional stem, class stem, task, arguments, input kind, float64 scores, summed in another order)
CASES = [
    ("precision", "Precision", "multiclass", {"average": "macro"}, "probs", False, False),
    ("recall", "Recall", "binary", {"multidim_average": "samplewise"}, "logits", False, False),
    ("fbeta_score", "FBetaScore", "multilabel", {"beta": 0.5, "average": "weighted"}, "probs", False, False),
    ("f1_score", "F1Score", "multiclass", {"average": "micro", "top_k": 2}, "probs", False, False),
    ("specificity", "Specificity", "multilabel", {"average": "none"}, "probs", False, False),
    ("negative_predictive_value", "NegativePredictiveValue", "binary", {}, "probs", True, False),
    ("hamming_distance", "HammingDistance", "multiclass", {"average": "weighted"}, "labels", False, False),
    ("confusion_matrix", "ConfusionMatrix", "multiclass", {}, "probs", False, False),
    ("confusion_matrix", "ConfusionMatrix", "multilabel", {"normalize": "true"}, "probs", False, False),
    ("exact_match", "ExactMatch", "multilabel", {}, "probs", False, False),
    ("exact_match", "ExactMatch", "multiclass", {"multidim_average": "samplewise"}, "labels", False, False),
    ("jaccard_index", "JaccardIndex", "multiclass", {"average": "weighted"}, "probs", False, False),
    ("cohen_kappa", "CohenKappa", "multiclass", {}, "probs", False, True),
    ("cohen_kappa", "CohenKappa", "binary", {"weights": "quadratic"}, "probs", False, True),
    ("matthews_corrcoef", "MatthewsCorrCoef", "multilabel", {}, "probs", False, False),
    ("calibration_error", "CalibrationError", "binary", {"n_bins": 10}, "probs", True, True),
    ("calibration_error", "CalibrationError", "multiclass", {"norm": "l2"}, "probs", False, True),
    ("coverage_error", "CoverageError", "multilabel", {}, "probs", False, False),
    ("ranking_average_precision", "RankingAveragePrecision", "multilabel", {}, "probs", False, False),
    ("ranking_loss", "RankingLoss", "multilabel", {}, "probs", False, False),
    ("hinge_loss", "HingeLoss", "binary", {"squared": True}, "logits", True, True),
    ("hinge_loss", "HingeLoss", "multiclass", {"multiclass_mode": "one-vs-all"}, "logits", False, True),
]


@pytest.mark.parametrize(("fn", "cls", "task", "args", "kind", "f64", "summed"), CASES,
                         ids=[f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(CASES)])
def test_float64_regime_matches_reference(fn, cls, task, args, kind, f64, summed):
    samplewise = args.get("multidim_average") == "samplewise" or fn == "exact_match"
    batches = []
    for seed in (1, 2):
        preds, target = inputs(task, kind, None, seed, samplewise=samplewise)
        batches.append((preds.astype(np.float64) if f64 else preds, target))
    if args.get("multidim_average") == "samplewise" and fn == "exact_match":
        batches = batches[:1]
    args = {**task_args(task), **args}
    tol = (SUM_RTOL, SUM_ATOL) if summed else ()
    previous = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        with jax.enable_x64(True):
            run_functional(TASK_FN[task] + fn, *batches[0], args, *tol)
            run_class(TASK_CLS[task] + cls, batches, args, *tol)
    finally:
        torch.set_default_dtype(previous)


def test_dice_in_the_float64_regime():
    """Dice's float states follow the default dtype; its result is float32, as the JAX package's."""
    rng = np.random.RandomState(3)
    batches = [(rng.randint(0, 4, 48), rng.randint(0, 4, 48)) for _ in range(2)]
    previous = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        with jax.enable_x64(True):
            for average in ("micro", "macro", "samples"):
                args = {"average": average, "num_classes": 4}
                run_functional("dice", *batches[0], args)
                run_class("Dice", batches, args)
    finally:
        torch.set_default_dtype(previous)
