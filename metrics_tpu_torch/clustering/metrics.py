"""Modular clustering metrics (counterpart of ``metrics_tpu/clustering/metrics.py``): every batch's labels (or
embeddings and labels) are kept in "cat" list states, and the score is computed from all of them at once."""

from __future__ import annotations

from typing import Any, Callable, List

from torch import Tensor

from metrics_tpu_torch.functional.clustering.extrinsic import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    completeness_score,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from metrics_tpu_torch.functional.clustering.intrinsic import (
    calinski_harabasz_score,
    davies_bouldin_score,
    dunn_index,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class _LabelClusteringMetric(Metric):
    """Shared plumbing: list states ``preds``/``target`` of cluster labels."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    preds: List[Tensor]
    target: List[Tensor]

    _compute_fn: Callable

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predicted and target cluster labels."""
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        """Compute metric over all accumulated labels."""
        return type(self)._compute_fn(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class MutualInfoScore(_LabelClusteringMetric):
    """Mutual information between clusterings.

    >>> import torch
    >>> metric = MutualInfoScore(device="cpu")
    >>> metric.update(torch.tensor([2, 1, 0, 1, 0]), torch.tensor([0, 2, 1, 1, 0]))
    >>> metric.compute()
    tensor(0.5004)
    """

    _compute_fn = staticmethod(mutual_info_score)


class RandScore(_LabelClusteringMetric):
    """Rand score.

    >>> import torch
    >>> metric = RandScore(device="cpu")
    >>> metric.update(torch.tensor([2, 1, 0, 1, 0]), torch.tensor([0, 2, 1, 1, 0]))
    >>> metric.compute()
    tensor(0.6000)
    """

    _compute_fn = staticmethod(rand_score)


class AdjustedRandScore(_LabelClusteringMetric):
    """Adjusted Rand score."""

    plot_lower_bound = -1.0
    _compute_fn = staticmethod(adjusted_rand_score)


class FowlkesMallowsIndex(_LabelClusteringMetric):
    """Fowlkes-Mallows index."""

    _compute_fn = staticmethod(fowlkes_mallows_index)


class HomogeneityScore(_LabelClusteringMetric):
    """Homogeneity score."""

    _compute_fn = staticmethod(homogeneity_score)


class CompletenessScore(_LabelClusteringMetric):
    """Completeness score."""

    _compute_fn = staticmethod(completeness_score)


class VMeasureScore(_LabelClusteringMetric):
    """V-measure, with ``beta`` weighing completeness against homogeneity."""

    def __init__(self, beta: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(beta, (int, float)) and beta > 0):
            raise ValueError(f"Argument `beta` should be a positive float. Got {beta}.")
        self.beta = float(beta)

    def compute(self) -> Tensor:
        """Compute metric."""
        return v_measure_score(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.beta)


class NormalizedMutualInfoScore(_LabelClusteringMetric):
    """Normalized mutual information."""

    def __init__(self, average_method: str = "arithmetic", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if average_method not in ("min", "geometric", "arithmetic", "max"):
            raise ValueError(f"Expected argument `average_method` to be one of (min, geometric, arithmetic, max),"
                             f" but got {average_method}")
        self.average_method = average_method

    def compute(self) -> Tensor:
        """Compute metric."""
        return normalized_mutual_info_score(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.average_method)


class AdjustedMutualInfoScore(NormalizedMutualInfoScore):
    """Adjusted mutual information; the expected mutual information is summed on the metric's device."""

    plot_lower_bound = -1.0

    def compute(self) -> Tensor:
        """Compute metric."""
        return adjusted_mutual_info_score(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.average_method)


class _EmbeddingClusteringMetric(Metric):
    """Shared plumbing: list states ``data``/``labels``."""

    is_differentiable = True
    full_state_update = True
    data: List[Tensor]
    labels: List[Tensor]

    _compute_fn: Callable

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("data", [], dist_reduce_fx="cat")
        self.add_state("labels", [], dist_reduce_fx="cat")

    def update(self, data: Tensor, labels: Tensor) -> None:
        """Update state with embeddings and cluster labels."""
        self.data.append(data)
        self.labels.append(labels)

    def compute(self) -> Tensor:
        """Compute metric over all accumulated embeddings."""
        return type(self)._compute_fn(dim_zero_cat(self.data), dim_zero_cat(self.labels))


class CalinskiHarabaszScore(_EmbeddingClusteringMetric):
    """Calinski-Harabasz score.

    >>> import torch
    >>> metric = CalinskiHarabaszScore(device="cpu")
    >>> metric.update(torch.tensor([[0., 0.], [0., 1.], [10., 10.], [10., 11.]]), torch.tensor([0, 0, 1, 1]))
    >>> metric.compute()
    tensor(400.)
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    _compute_fn = staticmethod(calinski_harabasz_score)


class DaviesBouldinScore(_EmbeddingClusteringMetric):
    """Davies-Bouldin score."""

    higher_is_better = False
    plot_lower_bound = 0.0
    _compute_fn = staticmethod(davies_bouldin_score)


class DunnIndex(_EmbeddingClusteringMetric):
    """Dunn index in the ``p``-norm."""

    higher_is_better = True
    plot_lower_bound = 0.0

    def __init__(self, p: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = p

    def compute(self) -> Tensor:
        """Compute metric."""
        return dunn_index(dim_zero_cat(self.data), dim_zero_cat(self.labels), self.p)
