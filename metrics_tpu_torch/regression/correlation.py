"""Correlation metrics (counterpart of ``metrics_tpu/regression/correlation.py``).

Ported so far: ``PearsonCorrCoef`` and ``SpearmanCorrCoef``. The module's
other classes (concordance, Kendall, R², relative squared error, explained
variance, cosine similarity, KL divergence) are not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from metrics_tpu_torch.functional.regression.pearson import (
    _final_aggregation,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from metrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

__all__ = ["PearsonCorrCoef", "SpearmanCorrCoef"]

Tensor = torch.Tensor


class PearsonCorrCoef(Metric):
    """Pearson correlation coefficient.

    The states are streaming moments reduced by ``dist_reduce_fx=None``: a
    sync gathers them to a stack with one row per rank, and ``compute`` folds
    the stack by Chan's pairwise merge (``_final_aggregation``).

    >>> metric = PearsonCorrCoef(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(0.9849)
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError("Expected argument `num_outputs` to be an int larger than 0")
        self.num_outputs = num_outputs
        shape = (num_outputs,) if num_outputs > 1 else ()
        for name in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"):
            self.add_state(name, torch.zeros(shape), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total,
            self.num_outputs,
        )

    def _sync_reduce(self) -> tuple:
        """The moments, with a stack of per-rank moments (after a sync) folded into one set."""
        if self.mean_x.ndim > (1 if self.num_outputs > 1 else 0):
            return _final_aggregation(self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total)
        return self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total

    def compute(self) -> Tensor:
        """Compute metric."""
        _, _, var_x, var_y, corr_xy, n_total = self._sync_reduce()
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation coefficient; the samples are kept in "cat" list states.

    >>> metric = SpearmanCorrCoef(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(1.0000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = _spearman_corrcoef_update(preds.to(torch.float32), target.to(torch.float32), self.num_outputs)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        """Compute metric."""
        return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))
