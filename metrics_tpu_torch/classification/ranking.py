"""Multilabel ranking metrics: a float sum state of the per-sample measures and an int64 count.

Counterpart of ``metrics_tpu/classification/ranking.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import _multilabel_confusion_matrix_format
from metrics_tpu_torch.functional.classification.ranking import (
    _multilabel_coverage_error_update,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_loss_update,
    _multilabel_ranking_tensor_validation,
    _ranking_reduce,
)
from metrics_tpu_torch.metric import Metric


class _MultilabelRankingBase(Metric):
    """Shared plumbing for the three ranking metrics."""

    is_differentiable = False
    full_state_update = False
    measure: Tensor
    total: Tensor

    _update_fn = None  # set by subclasses

    def __init__(
        self,
        num_labels: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args and (not isinstance(num_labels, int) or num_labels < 2):
            raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        if self.validate_args:
            _multilabel_ranking_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target = _multilabel_confusion_matrix_format(
            preds, target, self.num_labels, threshold=0.0, ignore_index=self.ignore_index, should_threshold=False
        )
        measure, total = type(self)._update_fn(preds, target)
        self.measure = self.measure + measure
        self.total = self.total + total

    def compute(self) -> Tensor:
        """Compute metric."""
        return _ranking_reduce(self.measure, self.total)


class MultilabelCoverageError(_MultilabelRankingBase):
    """Multilabel coverage error.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = torch.tensor(rng.rand(10, 5).astype(np.float32))
    >>> target = torch.tensor(rng.randint(2, size=(10, 5)))
    >>> mcr = MultilabelCoverageError(num_labels=5, device="cpu")
    >>> mcr.update(preds, target)
    >>> mcr.compute()
    tensor(4.2000)
    """

    higher_is_better = False
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_MultilabelRankingBase):
    """Label ranking average precision.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = torch.tensor(rng.rand(10, 5).astype(np.float32))
    >>> target = torch.tensor(rng.randint(2, size=(10, 5)))
    >>> mlrap = MultilabelRankingAveragePrecision(num_labels=5, device="cpu")
    >>> mlrap.update(preds, target)
    >>> mlrap.compute()
    tensor(0.7185)
    """

    higher_is_better = True
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_MultilabelRankingBase):
    """Label ranking loss.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = torch.tensor(rng.rand(10, 5).astype(np.float32))
    >>> target = torch.tensor(rng.randint(2, size=(10, 5)))
    >>> mlrl = MultilabelRankingLoss(num_labels=5, device="cpu")
    >>> mlrl.update(preds, target)
    >>> mlrl.compute()
    tensor(0.5083)
    """

    higher_is_better = False
    _update_fn = staticmethod(_multilabel_ranking_loss_update)
