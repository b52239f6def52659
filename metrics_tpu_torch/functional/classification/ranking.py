"""Multilabel ranking metrics: coverage error, label ranking average precision, label ranking loss.

Counterpart of ``metrics_tpu/functional/classification/ranking.py``. Ranking
average precision takes each label's rank from an (N, L, L) comparison, as
the JAX package does, instead of a loop over samples; ranking loss ranks with
a stable double argsort (ties to the lower label, as JAX's sort). Coverage
error offsets the irrelevant labels by the minimum over the whole batch. The
per-batch sums are float32 whatever the default dtype, as the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
)


def _ranking_reduce(score: Tensor, num_elements: Tensor) -> Tensor:
    """Final reduction: the sum of the per-sample measures over the number of samples."""
    return score / num_elements


def _multilabel_ranking_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    """Validate tensor inputs (reads the target's distinct values on the host)."""
    _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    if not preds.is_floating_point():
        raise ValueError(f"Expected preds tensor to be floating point, but received input with dtype {preds.dtype}")


def _multilabel_coverage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Accumulate state for coverage error."""
    offset = torch.where(target == 0, preds.min().abs() + 10, 0.0)
    preds_mod = preds + offset
    preds_min = preds_mod.amin(dim=1)
    coverage = (preds >= preds_min[:, None]).sum(dim=1).float()
    return coverage.sum(), torch.tensor(coverage.numel(), device=preds.device)


def multilabel_coverage_error(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute multilabel coverage error.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(10, 5).astype(np.float32))
    >>> target = torch.from_numpy(rng.randint(2, size=(10, 5)))
    >>> multilabel_coverage_error(preds, target, num_labels=5)
    tensor(4.2000)
    """
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(
        preds, target, num_labels, threshold=0.0, ignore_index=ignore_index, should_threshold=False
    )
    coverage, total = _multilabel_coverage_error_update(preds, target)
    return _ranking_reduce(coverage, total)


def _multilabel_ranking_average_precision_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """The sum of the samples' label ranking average precision, and their number.

    Each label's rank is the number of labels scored at least as high, from an
    (N, L, L) comparison; float32 whatever the default dtype.
    """
    num_preds, num_labels = preds.shape
    relevant = target == 1
    neg = -preds
    # le[i, l, m] = (neg[i, m] <= neg[i, l]): label l's rank is the sum over m
    le = neg[:, None, :] <= neg[:, :, None]
    rank_all = le.sum(-1).float()  # (N, L), >= 1: the diagonal is always true
    rank_rel = (le & relevant[:, None, :]).sum(-1).float()
    ratio = torch.where(relevant, rank_rel / rank_all, 0.0)
    n_rel = relevant.sum(dim=1)
    score_i = torch.where(
        (n_rel > 0) & (n_rel < num_labels),
        ratio.sum(dim=1) / n_rel.clamp(min=1),
        1.0,
    )
    return score_i.sum(), torch.tensor(num_preds, device=preds.device)


def multilabel_ranking_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute label ranking average precision.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(10, 5).astype(np.float32))
    >>> target = torch.from_numpy(rng.randint(2, size=(10, 5)))
    >>> multilabel_ranking_average_precision(preds, target, num_labels=5)
    tensor(0.7185)
    """
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(
        preds, target, num_labels, threshold=0.0, ignore_index=ignore_index, should_threshold=False
    )
    score, total = _multilabel_ranking_average_precision_update(preds, target)
    return _ranking_reduce(score, total)


def _multilabel_ranking_loss_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """The sum of the samples' label ranking loss, and their number."""
    num_preds, num_labels = preds.shape
    relevant = target == 1
    num_relevant = relevant.sum(dim=1)
    mask = (num_relevant > 0) & (num_relevant < num_labels)

    inverse = torch.argsort(torch.argsort(preds, dim=1, stable=True), dim=1, stable=True)
    per_label_loss = ((num_labels - inverse) * relevant).float()
    # the JAX package's weakly typed Python-float product takes the float32 sum's type in the subtraction
    correction = (0.5 * num_relevant * (num_relevant + 1)).to(per_label_loss.dtype)
    denom = num_relevant * (num_labels - num_relevant)
    loss = (per_label_loss.sum(dim=1) - correction) / denom.clamp(min=1)
    loss = torch.where(mask, loss, 0.0)
    return loss.sum(), torch.tensor(num_preds, device=preds.device)


def multilabel_ranking_loss(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Compute the label ranking loss.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.rand(10, 5).astype(np.float32))
    >>> target = torch.from_numpy(rng.randint(2, size=(10, 5)))
    >>> multilabel_ranking_loss(preds, target, num_labels=5)
    tensor(0.5083)
    """
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(
        preds, target, num_labels, threshold=0.0, ignore_index=ignore_index, should_threshold=False
    )
    loss, total = _multilabel_ranking_loss_update(preds, target)
    return _ranking_reduce(loss, total)
