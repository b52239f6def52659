"""The port's curve family in the float64 regime (torch's default dtype float64) against the JAX package
under x64; inputs and tolerances as ``tests/test_torch_curve_cases.py`` sets them out."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu_torch.classification as tc
from metrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
from tests.test_torch_curve_cases import FAMILIES, _compare, _inputs, _run_class, _run_functional


def _run_float64(family, task, thresholds, average):
    preds, target = _inputs(task, "probs", None, seed=14)
    extra = {**FAMILIES[family][2], **({} if average == "default" else {"average": average})}
    port, ref = _run_functional(family, task, preds, target, thresholds, None, extra)
    port_c, ref_c = _run_class(family, task, [(preds, target)], thresholds, None, extra)
    return (port, port_c.compute()), (ref, ref_c.compute())


@pytest.mark.parametrize("thresholds", [None, 20], ids=["exact", "int"])
@pytest.mark.parametrize(("family", "task", "average"), [
    ("prc", "multilabel", "default"), ("roc", "binary", "default"), ("roc", "multiclass", "macro"),
    ("auroc", "multilabel", "macro"), ("auroc", "binary", "default"), ("ap", "multiclass", "weighted"),
    ("ap", "multilabel", "micro"), ("logauc", "binary", "default"), ("sens_at_spec", "multilabel", "default"),
    ("rec_at_prec", "binary", "default"),
])
def test_float64_regime_matches_reference(family, task, average, thresholds):
    """torch's default dtype float64 against JAX's x64: the same values, in the same dtypes (float32
    scores stay float32; float64 thresholds are compared exactly, so a float32 score on the grid counts
    as it does in the JAX package)."""
    previous = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        with jax.enable_x64(True):
            got, want = _run_float64(family, task, thresholds, average)
    finally:
        torch.set_default_dtype(previous)
    _compare(got, want, family, None if average == "default" else average, thresholds, "probs")


def test_float32_scores_on_a_float64_grid_count_as_in_reference():
    """Under float64 the int grid is float64, and the kernel takes float32 thresholds: a float32 score equal
    to a threshold rounded down to float32 lies below the float64 threshold, as the JAX package counts it."""
    previous = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        grid = _adjust_threshold_arg(20).numpy()
        preds = np.repeat(grid.astype(np.float32), 3)
        assert (preds.astype(np.float64) < np.repeat(grid, 3)).any()  # some thresholds round down
        target = np.random.RandomState(20).randint(0, 2, preds.shape[0])
        port = tc.BinaryPrecisionRecallCurve(thresholds=20, device="cpu")
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        with jax.enable_x64(True):
            ref = jc.BinaryPrecisionRecallCurve(thresholds=20)
            ref.update(jnp.asarray(preds), jnp.asarray(target))
            np.testing.assert_array_equal(port.confmat.numpy(), np.asarray(ref.confmat))
    finally:
        torch.set_default_dtype(previous)
