"""Classification metrics, exported in the order of the JAX package's ``__all__``.

Not ported yet: ``BinaryFairness`` and ``BinaryGroupStatRates`` (``group_fairness.py``).
"""

from metrics_tpu_torch.classification.calibration_error import (
    BinaryCalibrationError,
    CalibrationError,
    MulticlassCalibrationError,
)
from metrics_tpu_torch.classification.hinge import BinaryHingeLoss, HingeLoss, MulticlassHingeLoss
from metrics_tpu_torch.classification.logauc import BinaryLogAUC, LogAUC, MulticlassLogAUC, MultilabelLogAUC
from metrics_tpu_torch.classification.precision_fixed_recall import (
    BinaryPrecisionAtFixedRecall,
    MulticlassPrecisionAtFixedRecall,
    MultilabelPrecisionAtFixedRecall,
    PrecisionAtFixedRecall,
)
from metrics_tpu_torch.classification.ranking import (
    MultilabelCoverageError,
    MultilabelRankingAveragePrecision,
    MultilabelRankingLoss,
)
from metrics_tpu_torch.classification.recall_fixed_precision import (
    BinaryRecallAtFixedPrecision,
    MulticlassRecallAtFixedPrecision,
    MultilabelRecallAtFixedPrecision,
    RecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.sensitivity_specificity import (
    BinarySensitivityAtSpecificity,
    MulticlassSensitivityAtSpecificity,
    MultilabelSensitivityAtSpecificity,
    SensitivityAtSpecificity,
)
from metrics_tpu_torch.classification.specificity_sensitivity import (
    BinarySpecificityAtSensitivity,
    MulticlassSpecificityAtSensitivity,
    MultilabelSpecificityAtSensitivity,
    SpecificityAtSensitivity,
)
from metrics_tpu_torch.classification.auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from metrics_tpu_torch.classification.average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from metrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from metrics_tpu_torch.classification.roc import ROC, BinaryROC, MulticlassROC, MultilabelROC
from metrics_tpu_torch.classification.accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from metrics_tpu_torch.classification.cohen_kappa import BinaryCohenKappa, CohenKappa, MulticlassCohenKappa
from metrics_tpu_torch.classification.dice import Dice
from metrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from metrics_tpu_torch.classification.exact_match import ExactMatch, MulticlassExactMatch, MultilabelExactMatch
from metrics_tpu_torch.classification.f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MultilabelF1Score,
    MultilabelFBetaScore,
)
from metrics_tpu_torch.classification.hamming import (
    BinaryHammingDistance,
    HammingDistance,
    MulticlassHammingDistance,
    MultilabelHammingDistance,
)
from metrics_tpu_torch.classification.jaccard import (
    BinaryJaccardIndex,
    JaccardIndex,
    MulticlassJaccardIndex,
    MultilabelJaccardIndex,
)
from metrics_tpu_torch.classification.matthews_corrcoef import (
    BinaryMatthewsCorrCoef,
    MatthewsCorrCoef,
    MulticlassMatthewsCorrCoef,
    MultilabelMatthewsCorrCoef,
)
from metrics_tpu_torch.classification.negative_predictive_value import (
    BinaryNegativePredictiveValue,
    MulticlassNegativePredictiveValue,
    MultilabelNegativePredictiveValue,
    NegativePredictiveValue,
)
from metrics_tpu_torch.classification.precision_recall import (
    BinaryPrecision,
    BinaryRecall,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelPrecision,
    MultilabelRecall,
    Precision,
    Recall,
)
from metrics_tpu_torch.classification.specificity import (
    BinarySpecificity,
    MulticlassSpecificity,
    MultilabelSpecificity,
    Specificity,
)
from metrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    StatScores,
)

__all__ = [
    "BinaryCalibrationError", "CalibrationError", "MulticlassCalibrationError",
    "BinaryHingeLoss", "HingeLoss", "MulticlassHingeLoss",
    "BinaryLogAUC", "LogAUC", "MulticlassLogAUC", "MultilabelLogAUC",
    "BinaryPrecisionAtFixedRecall", "MulticlassPrecisionAtFixedRecall", "MultilabelPrecisionAtFixedRecall",
    "PrecisionAtFixedRecall",
    "MultilabelCoverageError", "MultilabelRankingAveragePrecision", "MultilabelRankingLoss",
    "BinaryRecallAtFixedPrecision", "MulticlassRecallAtFixedPrecision", "MultilabelRecallAtFixedPrecision",
    "RecallAtFixedPrecision",
    "BinarySensitivityAtSpecificity", "MulticlassSensitivityAtSpecificity", "MultilabelSensitivityAtSpecificity",
    "SensitivityAtSpecificity",
    "BinarySpecificityAtSensitivity", "MulticlassSpecificityAtSensitivity", "MultilabelSpecificityAtSensitivity",
    "SpecificityAtSensitivity",
    "AUROC", "BinaryAUROC", "MulticlassAUROC", "MultilabelAUROC",
    "AveragePrecision", "BinaryAveragePrecision", "MulticlassAveragePrecision", "MultilabelAveragePrecision",
    "BinaryPrecisionRecallCurve", "MulticlassPrecisionRecallCurve", "MultilabelPrecisionRecallCurve",
    "PrecisionRecallCurve",
    "ROC", "BinaryROC", "MulticlassROC", "MultilabelROC",
    "Accuracy", "BinaryAccuracy", "MulticlassAccuracy", "MultilabelAccuracy",
    "BinaryCohenKappa", "CohenKappa", "MulticlassCohenKappa",
    "BinaryConfusionMatrix", "ConfusionMatrix",
    "Dice", "MulticlassConfusionMatrix", "MultilabelConfusionMatrix",
    "ExactMatch", "MulticlassExactMatch", "MultilabelExactMatch",
    "BinaryF1Score", "BinaryFBetaScore", "F1Score", "FBetaScore",
    "MulticlassF1Score", "MulticlassFBetaScore", "MultilabelF1Score", "MultilabelFBetaScore",
    "BinaryHammingDistance", "HammingDistance", "MulticlassHammingDistance", "MultilabelHammingDistance",
    "BinaryJaccardIndex", "JaccardIndex", "MulticlassJaccardIndex", "MultilabelJaccardIndex",
    "BinaryMatthewsCorrCoef", "MatthewsCorrCoef", "MulticlassMatthewsCorrCoef", "MultilabelMatthewsCorrCoef",
    "BinaryNegativePredictiveValue", "MulticlassNegativePredictiveValue", "MultilabelNegativePredictiveValue",
    "NegativePredictiveValue",
    "BinaryPrecision", "BinaryRecall", "MulticlassPrecision", "MulticlassRecall",
    "MultilabelPrecision", "MultilabelRecall", "Precision", "Recall",
    "BinarySpecificity", "MulticlassSpecificity", "MultilabelSpecificity", "Specificity",
    "BinaryStatScores", "MulticlassStatScores", "MultilabelStatScores", "StatScores",
]
