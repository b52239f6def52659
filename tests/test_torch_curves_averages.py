"""The port's curve averages (micro, macro, weighted, none) against the JAX package's, for each family that
takes one; inputs and tolerances as ``tests/test_torch_curve_cases.py`` sets them out."""

from __future__ import annotations

import pytest

from tests.test_torch_curve_cases import _compare, _inputs, _run_class, _run_functional

AVERAGES = [
    ("prc", "multiclass", "micro"), ("prc", "multiclass", "macro"),
    ("roc", "multiclass", "micro"), ("roc", "multiclass", "macro"),
    ("auroc", "multiclass", "weighted"), ("auroc", "multiclass", "none"),
    ("auroc", "multilabel", "micro"), ("auroc", "multilabel", "weighted"), ("auroc", "multilabel", "none"),
    ("ap", "multiclass", "weighted"), ("ap", "multiclass", None),
    ("ap", "multilabel", "micro"), ("ap", "multilabel", "weighted"), ("ap", "multilabel", "none"),
    ("logauc", "multiclass", "macro"), ("logauc", "multilabel", "macro"), ("logauc", "multilabel", None),
]


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("thresholds", [None, 7, "tensor"], ids=["exact", "int", "tensor-unsorted"])
@pytest.mark.parametrize(("family", "task", "average"), AVERAGES)
def test_averages_match_reference(family, task, average, thresholds, ignore_index):
    preds, target = _inputs(task, "probs", ignore_index, seed=4)
    port, ref = _run_functional(family, task, preds, target, thresholds, ignore_index, {"average": average})
    _compare(port, ref, family, average, thresholds, "probs")

    batches = [_inputs(task, "probs", ignore_index, seed=s) for s in (5, 6)]
    port, ref = _run_class(family, task, batches, thresholds, ignore_index, {"average": average})
    _compare(port.compute(), ref.compute(), family, average, thresholds, "probs")
