"""Classification metrics."""

from metrics_tpu_torch.classification.accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
)
from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    StatScores,
)

__all__ = [
    "Accuracy",
    "BinaryAccuracy",
    "BinaryPrecisionRecallCurve",
    "BinaryStatScores",
    "MulticlassAccuracy",
    "MulticlassPrecisionRecallCurve",
    "MulticlassStatScores",
    "MultilabelAccuracy",
    "MultilabelStatScores",
    "StatScores",
]
