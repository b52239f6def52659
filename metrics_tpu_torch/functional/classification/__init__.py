"""Functional classification metrics."""

from metrics_tpu_torch.functional.classification.accuracy import (
    accuracy,
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    precision_recall_curve,
)
from metrics_tpu_torch.functional.classification.stat_scores import (
    binary_stat_scores,
    multiclass_stat_scores,
    multilabel_stat_scores,
    stat_scores,
)

__all__ = [
    "accuracy",
    "binary_accuracy",
    "binary_precision_recall_curve",
    "binary_stat_scores",
    "multiclass_accuracy",
    "multiclass_precision_recall_curve",
    "multiclass_stat_scores",
    "multilabel_accuracy",
    "multilabel_stat_scores",
    "precision_recall_curve",
    "stat_scores",
]
