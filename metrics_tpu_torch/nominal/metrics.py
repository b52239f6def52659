"""Modular nominal metrics (counterpart of ``metrics_tpu/nominal/metrics.py``): the two variables, or the
ratings, kept in "cat" list states.

``FleissKappa(mode="probs")`` concatenates its updates along the samples (dim 0), so several updates give
the value of one update of all their samples. The JAX package concatenates probabilities along dim 1, the
categories, which is right for one update only.
"""

from __future__ import annotations

from typing import Any, List, Optional

from torch import Tensor

from metrics_tpu_torch.functional.nominal.metrics import (
    cramers_v,
    fleiss_kappa,
    pearsons_contingency_coefficient,
    theils_u,
    tschuprows_t,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class _NominalMetric(Metric):
    """Shared plumbing: list states of the two categorical variables."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    preds: List[Tensor]
    target: List[Tensor]

    def __init__(self, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if nan_strategy not in ("replace", "drop"):
            raise ValueError(f"Argument `nan_strategy` is expected to be one of `('replace', 'drop')`, "
                             f"but got {nan_strategy}")
        if nan_strategy == "replace" and not isinstance(nan_replace_value, (int, float)):
            raise ValueError("Argument `nan_replace_value` is expected to be of a type `int` or `float` when "
                             f"`nan_strategy = 'replace`, but got {nan_replace_value}")
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with the two categorical variables."""
        self.preds.append(preds.reshape(-1))
        self.target.append(target.reshape(-1))


class CramersV(_NominalMetric):
    """Cramer's V between two categorical variables.

    >>> import numpy as np
    >>> import torch
    >>> rng = np.random.RandomState(42)
    >>> preds = rng.randint(0, 4, (100,))
    >>> target = (preds + rng.randint(0, 2, (100,))) % 4
    >>> metric = CramersV(num_classes=4, device="cpu")
    >>> metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    >>> round(float(metric.compute()), 4)
    0.577
    """

    def __init__(self, num_classes: int, bias_correction: bool = True, nan_strategy: str = "replace",
                 nan_replace_value: Optional[float] = 0.0, **kwargs: Any) -> None:
        super().__init__(nan_strategy, nan_replace_value, **kwargs)
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError("Argument `num_classes` has to be a positive integer")
        self.num_classes = num_classes
        self.bias_correction = bias_correction

    def compute(self) -> Tensor:
        """Compute metric."""
        return cramers_v(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.bias_correction,
                         self.nan_strategy, self.nan_replace_value)


class TschuprowsT(CramersV):
    """Tschuprow's T between two categorical variables."""

    def compute(self) -> Tensor:
        """Compute metric."""
        return tschuprows_t(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.bias_correction,
                            self.nan_strategy, self.nan_replace_value)


class PearsonsContingencyCoefficient(_NominalMetric):
    """Pearson's contingency coefficient between two categorical variables."""

    def __init__(self, num_classes: int, nan_strategy: str = "replace",
                 nan_replace_value: Optional[float] = 0.0, **kwargs: Any) -> None:
        super().__init__(nan_strategy, nan_replace_value, **kwargs)
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError("Argument `num_classes` has to be a positive integer")
        self.num_classes = num_classes

    def compute(self) -> Tensor:
        """Compute metric."""
        return pearsons_contingency_coefficient(dim_zero_cat(self.preds), dim_zero_cat(self.target),
                                                self.nan_strategy, self.nan_replace_value)


class TheilsU(PearsonsContingencyCoefficient):
    """Theil's U, the uncertainty coefficient U(preds | target)."""

    def compute(self) -> Tensor:
        """Compute metric."""
        return theils_u(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.nan_strategy,
                        self.nan_replace_value)


class FleissKappa(Metric):
    """Fleiss' kappa for inter-rater agreement over every sample seen so far.

    >>> import torch
    >>> metric = FleissKappa(mode='counts', device="cpu")
    >>> metric.update(torch.tensor([[0, 0, 14], [0, 2, 12], [0, 6, 8], [0, 12, 2]]))
    >>> round(float(metric.compute()), 4)
    0.4256
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    ratings: List[Tensor]

    def __init__(self, mode: str = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ("counts", "probs"):
            raise ValueError("Argument ``mode`` must be one of 'counts' or 'probs'")
        self.mode = mode
        self.add_state("ratings", [], dist_reduce_fx="cat")

    def update(self, ratings: Tensor) -> None:
        """Update state with rating counts or probabilities."""
        self.ratings.append(ratings)

    def compute(self) -> Tensor:
        """Compute metric over the samples of every update (each mode concatenates along the samples)."""
        return fleiss_kappa(dim_zero_cat(self.ratings), self.mode)
