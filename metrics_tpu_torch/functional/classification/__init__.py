"""Functional classification metrics, exported in the order of the JAX package's ``__all__``.

Not ported yet: the group-fairness functions (``group_fairness.py``) and the
``generalized_dice_score`` alias of the segmentation domain.
"""

from metrics_tpu_torch.functional.classification.calibration_error import (
    binary_calibration_error,
    calibration_error,
    multiclass_calibration_error,
)
from metrics_tpu_torch.functional.classification.hinge import binary_hinge_loss, hinge_loss, multiclass_hinge_loss
from metrics_tpu_torch.functional.classification.logauc import (
    binary_logauc,
    logauc,
    multiclass_logauc,
    multilabel_logauc,
)
from metrics_tpu_torch.functional.classification.precision_fixed_recall import (
    binary_precision_at_fixed_recall,
    multiclass_precision_at_fixed_recall,
    multilabel_precision_at_fixed_recall,
    precision_at_fixed_recall,
)
from metrics_tpu_torch.functional.classification.ranking import (
    multilabel_coverage_error,
    multilabel_ranking_average_precision,
    multilabel_ranking_loss,
)
from metrics_tpu_torch.functional.classification.recall_fixed_precision import (
    binary_recall_at_fixed_precision,
    multiclass_recall_at_fixed_precision,
    multilabel_recall_at_fixed_precision,
    recall_at_fixed_precision,
)
from metrics_tpu_torch.functional.classification.sensitivity_specificity import (
    binary_sensitivity_at_specificity,
    multiclass_sensitivity_at_specificity,
    multilabel_sensitivity_at_specificity,
    sensitivity_at_specificity,
)
from metrics_tpu_torch.functional.classification.specificity_sensitivity import (
    binary_specificity_at_sensitivity,
    multiclass_specificity_at_sensitivity,
    multilabel_specificity_at_sensitivity,
    specificity_at_sensitivity,
)
from metrics_tpu_torch.functional.classification.auroc import auroc, binary_auroc, multiclass_auroc, multilabel_auroc
from metrics_tpu_torch.functional.classification.average_precision import (
    average_precision,
    binary_average_precision,
    multiclass_average_precision,
    multilabel_average_precision,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
    precision_recall_curve,
)
from metrics_tpu_torch.functional.classification.roc import binary_roc, multiclass_roc, multilabel_roc, roc
from metrics_tpu_torch.functional.classification.accuracy import (
    accuracy,
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
)
from metrics_tpu_torch.functional.classification.cohen_kappa import (
    binary_cohen_kappa,
    cohen_kappa,
    multiclass_cohen_kappa,
)
from metrics_tpu_torch.functional.classification.dice import dice
from metrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from metrics_tpu_torch.functional.classification.exact_match import (
    exact_match,
    multiclass_exact_match,
    multilabel_exact_match,
)
from metrics_tpu_torch.functional.classification.f_beta import (
    binary_f1_score,
    binary_fbeta_score,
    f1_score,
    fbeta_score,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multilabel_f1_score,
    multilabel_fbeta_score,
)
from metrics_tpu_torch.functional.classification.hamming import (
    binary_hamming_distance,
    hamming_distance,
    multiclass_hamming_distance,
    multilabel_hamming_distance,
)
from metrics_tpu_torch.functional.classification.jaccard import (
    binary_jaccard_index,
    jaccard_index,
    multiclass_jaccard_index,
    multilabel_jaccard_index,
)
from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    binary_matthews_corrcoef,
    matthews_corrcoef,
    multiclass_matthews_corrcoef,
    multilabel_matthews_corrcoef,
)
from metrics_tpu_torch.functional.classification.negative_predictive_value import (
    binary_negative_predictive_value,
    multiclass_negative_predictive_value,
    multilabel_negative_predictive_value,
    negative_predictive_value,
)
from metrics_tpu_torch.functional.classification.precision_recall import (
    binary_precision,
    binary_recall,
    multiclass_precision,
    multiclass_recall,
    multilabel_precision,
    multilabel_recall,
    precision,
    recall,
)
from metrics_tpu_torch.functional.classification.specificity import (
    binary_specificity,
    multiclass_specificity,
    multilabel_specificity,
    specificity,
)
from metrics_tpu_torch.functional.classification.stat_scores import (
    binary_stat_scores,
    stat_scores,
    multiclass_stat_scores,
    multilabel_stat_scores,
)


__all__ = [
    "dice",
    "binary_calibration_error", "calibration_error", "multiclass_calibration_error",
    "binary_hinge_loss", "hinge_loss", "multiclass_hinge_loss",
    "binary_logauc", "logauc", "multiclass_logauc", "multilabel_logauc",
    "binary_precision_at_fixed_recall", "multiclass_precision_at_fixed_recall",
    "multilabel_precision_at_fixed_recall", "precision_at_fixed_recall",
    "multilabel_coverage_error", "multilabel_ranking_average_precision", "multilabel_ranking_loss",
    "binary_recall_at_fixed_precision", "multiclass_recall_at_fixed_precision",
    "multilabel_recall_at_fixed_precision", "recall_at_fixed_precision",
    "binary_sensitivity_at_specificity", "multiclass_sensitivity_at_specificity",
    "multilabel_sensitivity_at_specificity", "sensitivity_at_specificity",
    "binary_specificity_at_sensitivity", "multiclass_specificity_at_sensitivity",
    "multilabel_specificity_at_sensitivity", "specificity_at_sensitivity",
    "auroc", "binary_auroc", "multiclass_auroc", "multilabel_auroc",
    "average_precision", "binary_average_precision", "multiclass_average_precision", "multilabel_average_precision",
    "binary_precision_recall_curve", "multiclass_precision_recall_curve", "multilabel_precision_recall_curve",
    "precision_recall_curve",
    "binary_roc", "multiclass_roc", "multilabel_roc", "roc",
    "accuracy", "binary_accuracy", "multiclass_accuracy", "multilabel_accuracy",
    "binary_cohen_kappa", "cohen_kappa", "multiclass_cohen_kappa",
    "binary_confusion_matrix", "confusion_matrix", "multiclass_confusion_matrix", "multilabel_confusion_matrix",
    "exact_match", "multiclass_exact_match", "multilabel_exact_match",
    "binary_f1_score", "binary_fbeta_score", "f1_score", "fbeta_score",
    "multiclass_f1_score", "multiclass_fbeta_score", "multilabel_f1_score", "multilabel_fbeta_score",
    "binary_hamming_distance", "hamming_distance", "multiclass_hamming_distance", "multilabel_hamming_distance",
    "binary_jaccard_index", "jaccard_index", "multiclass_jaccard_index", "multilabel_jaccard_index",
    "binary_matthews_corrcoef", "matthews_corrcoef", "multiclass_matthews_corrcoef", "multilabel_matthews_corrcoef",
    "binary_negative_predictive_value", "multiclass_negative_predictive_value",
    "multilabel_negative_predictive_value", "negative_predictive_value",
    "binary_precision", "binary_recall", "multiclass_precision", "multiclass_recall",
    "multilabel_precision", "multilabel_recall", "precision", "recall",
    "binary_specificity", "multiclass_specificity", "multilabel_specificity", "specificity",
    "binary_stat_scores", "multiclass_stat_scores", "multilabel_stat_scores", "stat_scores",
]
