"""Segmentation metrics (counterpart of ``metrics_tpu/segmentation/metrics.py``): Dice (per-sample sums in
"cat" list states), generalized Dice, mean IoU and the Hausdorff distance (running sums and counters)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.segmentation.metrics import (
    _dice_score_compute,
    _dice_update,
    generalized_dice_score,
    hausdorff_distance,
    mean_iou,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import acc_dtype, count_dtype
from metrics_tpu_torch.utils.data import dim_zero_cat


class DiceScore(Metric):
    """The sample mean of per-sample Dice scores over every batch seen so far; each batch's per-sample, per-class
    numerators, denominators and supports are kept.

    >>> import numpy as np
    >>> rng = np.random.RandomState(0)
    >>> metric = DiceScore(num_classes=3, device="cpu")
    >>> metric.update(torch.from_numpy(rng.randint(0, 2, (4, 3, 16, 16))),
    ...               torch.from_numpy(rng.randint(0, 2, (4, 3, 16, 16))))
    >>> round(float(metric.compute()), 3)
    0.494
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        include_background: bool = True,
        average: Optional[str] = "micro",
        input_format: str = "one-hot",
        aggregation_level: str = "samplewise",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if average not in ("micro", "macro", "weighted", "none", None):
            raise ValueError(
                f"Expected argument `average` to be one of ('micro','macro','weighted','none'), got {average}"
            )
        if input_format not in ("one-hot", "index"):
            raise ValueError(f"Expected argument `input_format` to be one of 'one-hot', 'index', got {input_format}")
        if aggregation_level not in ("samplewise", "global"):
            raise ValueError(
                f"Expected argument `aggregation_level` to be one of 'samplewise', 'global', got {aggregation_level}"
            )
        self.num_classes = num_classes
        self.include_background = include_background
        self.average = average
        self.input_format = input_format
        self.aggregation_level = aggregation_level
        self.add_state("numerator", [], dist_reduce_fx="cat")
        self.add_state("denominator", [], dist_reduce_fx="cat")
        self.add_state("support", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with the batch's per-sample, per-class sums."""
        numerator, denominator, support, _ = _dice_update(
            preds, target, self.num_classes, self.input_format, self.include_background
        )
        self.numerator.append(numerator)
        self.denominator.append(denominator)
        self.support.append(support)

    def compute(self) -> torch.Tensor:
        """The sample mean of the per-sample Dice scores (one pooled row with ``aggregation_level="global"``)."""
        numerator = dim_zero_cat(self.numerator)
        denominator = dim_zero_cat(self.denominator)
        support = dim_zero_cat(self.support)
        if self.aggregation_level == "global":
            numerator = numerator.sum(0, keepdim=True)
            denominator = denominator.sum(0, keepdim=True)
            support = support.sum(0, keepdim=True)
        return _dice_score_compute(
            numerator, denominator, self.average, support=support if self.average == "weighted" else None
        ).mean(0)


class GeneralizedDiceScore(Metric):
    """The sample mean of generalized Dice scores over every batch seen so far (per class with ``per_class``).

    >>> import numpy as np
    >>> rng = np.random.RandomState(0)
    >>> metric = GeneralizedDiceScore(num_classes=3, input_format="index", device="cpu")
    >>> preds = torch.from_numpy(rng.randint(0, 3, (4, 16, 16)))
    >>> metric.update(preds, torch.from_numpy(rng.randint(0, 3, (4, 16, 16))))
    >>> round(float(metric.compute()), 3)
    0.329
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        include_background: bool = True,
        per_class: bool = False,
        weight_type: str = "square",
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.weight_type = weight_type
        self.input_format = input_format
        shape = (num_classes - (0 if include_background else 1),) if per_class else ()
        self.add_state("score", torch.zeros(shape, dtype=acc_dtype()), dist_reduce_fx="sum")
        self.add_state("samples", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with the batch's summed per-sample scores."""
        score = generalized_dice_score(
            preds, target, self.num_classes, self.include_background, self.per_class,
            self.weight_type, self.input_format,
        )
        self.score = self.score + score.sum(0)
        self.samples = self.samples + preds.shape[0]

    def compute(self) -> torch.Tensor:
        """The mean score over every sample so far."""
        return self.score / self.samples


class MeanIoU(Metric):
    """The mean over batches of each batch's mean IoU (per class with ``per_class``).

    >>> import numpy as np
    >>> rng = np.random.RandomState(0)
    >>> metric = MeanIoU(num_classes=3, input_format="index", device="cpu")
    >>> preds = torch.from_numpy(rng.randint(0, 3, (4, 16, 16)))
    >>> metric.update(preds, torch.from_numpy(rng.randint(0, 3, (4, 16, 16))))
    >>> round(float(metric.compute()), 3)
    0.198
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        include_background: bool = True,
        per_class: bool = False,
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.input_format = input_format
        shape = (num_classes - (0 if include_background else 1),) if per_class else ()
        self.add_state("score", torch.zeros(shape, dtype=acc_dtype()), dist_reduce_fx="sum")
        self.add_state("num_batches", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with the batch's mean IoU."""
        score = mean_iou(preds, target, self.num_classes, self.include_background, self.per_class, self.input_format)
        self.score = self.score + (score.mean(0) if self.per_class else score.mean())
        self.num_batches = self.num_batches + 1

    def compute(self) -> torch.Tensor:
        """The mean over every batch so far."""
        return self.score / self.num_batches


class HausdorffDistance(Metric):
    """The mean Hausdorff distance over every (sample, class) cell seen so far."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        num_classes: int,
        include_background: bool = False,
        distance_metric: str = "euclidean",
        spacing: Optional[Tuple[float, ...]] = None,
        directed: bool = False,
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.include_background = include_background
        self.distance_metric = distance_metric
        self.spacing = spacing
        self.directed = directed
        self.input_format = input_format
        self.add_state("score", torch.zeros((), dtype=acc_dtype()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with the batch's distances."""
        score = hausdorff_distance(
            preds, target, self.num_classes, self.include_background, self.distance_metric,
            self.spacing, self.directed, self.input_format,
        )
        self.score = self.score + score.sum()
        self.total = self.total + score.numel()

    def compute(self) -> torch.Tensor:
        """The mean over every (sample, class) cell so far."""
        return self.score / self.total


HausdorffDistance.__jit_ineligible__ = True  # host-side point-set distances, as in the JAX package
