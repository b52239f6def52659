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


def _float64_scores_near_the_grid(shape, thresholds, seed):
    """float64 scores on the float64 grid, or within half a float32 ulp of it (above and below), so that
    rounding them to float32 moves some across a threshold."""
    rng = np.random.RandomState(seed)
    grid = _adjust_threshold_arg(thresholds).numpy()
    on = grid[rng.randint(1, thresholds - 1, shape)]
    half_ulp = np.spacing(on.astype(np.float32)).astype(np.float64) / 2
    offset = np.where(rng.rand(*shape) < 0.5, -1, 1) * half_ulp * rng.uniform(0.1, 0.9, shape)
    return np.where(rng.rand(*shape) < 0.3, on, on + offset)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_float64_scores_are_compared_in_float64(task):
    """float64 scores within half a float32 ulp of the float64 grid: the binned confusion state and AUROC
    are the JAX package's under x64, which compares in float64 (rounded to float32 first, some of these
    scores would cross a threshold)."""
    previous = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        rng = np.random.RandomState(21)
        shape = (48,) if task == "binary" else (48, 4)
        preds = _float64_scores_near_the_grid(shape, 20, 22)
        if task == "multiclass":
            target = rng.randint(0, 4, 48)
            preds = preds / preds.sum(1, keepdims=True)  # probabilities, still float64
        else:
            target = rng.randint(0, 2, shape)
        grid = _adjust_threshold_arg(20).numpy()
        rounded = preds.astype(np.float32).astype(np.float64)
        assert ((rounded[..., None] >= grid) != (preds[..., None] >= grid)).any()  # the fault would show
        prefix = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}[task]
        extra = {"multiclass": {"num_classes": 4}, "multilabel": {"num_labels": 4}}.get(task, {})
        port_prc = getattr(tc, prefix + "PrecisionRecallCurve")(thresholds=20, device="cpu", **extra)
        port_auroc = getattr(tc, prefix + "AUROC")(thresholds=20, device="cpu", **extra)
        for metric in (port_prc, port_auroc):
            metric.update(torch.from_numpy(preds), torch.from_numpy(target))
        with jax.enable_x64(True):
            ref_prc = getattr(jc, prefix + "PrecisionRecallCurve")(thresholds=20, **extra)
            ref_auroc = getattr(jc, prefix + "AUROC")(thresholds=20, **extra)
            for metric in (ref_prc, ref_auroc):
                metric.update(jnp.asarray(preds), jnp.asarray(target))
            np.testing.assert_array_equal(port_prc.confmat.numpy(), np.asarray(ref_prc.confmat))
            np.testing.assert_array_equal(port_auroc.confmat.numpy(), np.asarray(ref_auroc.confmat))
            want = np.asarray(ref_auroc.compute())
        got = port_auroc.compute()
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    finally:
        torch.set_default_dtype(previous)


def test_binned_counts_reject_mixed_score_and_threshold_types():
    """Scores and thresholds are both float32 or both float64, on the CPU as on the card."""
    from metrics_tpu_torch.ops.binned_hist import binned_counts, binned_counts_labels

    preds = torch.rand(8, 2)
    target01 = torch.randint(0, 2, (8, 2), dtype=torch.int32)
    valid = torch.ones(8, 2, dtype=torch.bool)
    labels = torch.randint(0, 2, (8,), dtype=torch.int32)
    grid = torch.linspace(0, 1, 5)
    for p, t in ((preds, grid.double()), (preds.double(), grid), (preds.half(), grid.half())):
        with pytest.raises(TypeError, match="float32 preds with float32 thresholds or float64 with float64"):
            binned_counts(p, target01, valid, t)
        with pytest.raises(TypeError, match="float32 preds with float32 thresholds or float64 with float64"):
            binned_counts_labels(p, labels, t)
    for p, t in ((preds, grid), (preds.double(), grid.double())):
        assert binned_counts(p, target01, valid, t)[0].shape == (2, 5)
        assert binned_counts_labels(p, labels, t)[0].shape == (2, 5)
