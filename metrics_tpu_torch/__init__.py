"""metrics_tpu_torch: the PyTorch/CUDA port of ``metrics_tpu``.

The package keeps the JAX package's module layout and names, so each module has
an obvious counterpart in ``metrics_tpu/``. Metric state lives on an explicit
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``); the two Pallas
kernels of the JAX package are hand-written CUDA kernels under ``csrc/``, built
with ``nvcc`` at first use and launched through ``ops/``.

The names are those of ``metrics_tpu.__all__`` that are ported, in its order.
"""

from metrics_tpu_torch.aggregation import (
    CatMetric,
    MaxMetric,
    MeanMetric,
    MinMetric,
    RunningMean,
    RunningSum,
    SumMetric,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import CompositionalMetric, Metric

from metrics_tpu_torch import (  # noqa: E402 (the domains import the runtime above)
    classification,
    detection,
    functional,
    image,
    ops,
    parallel,
    regression,
    retrieval,
    utils,
    wrappers,
)
from metrics_tpu_torch.classification import (  # noqa: E402
    AUROC,
    ROC,
    Accuracy,
    AveragePrecision,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    Dice,
    ExactMatch,
    F1Score,
    FBetaScore,
    HammingDistance,
    HingeLoss,
    JaccardIndex,
    LogAUC,
    MatthewsCorrCoef,
    NegativePredictiveValue,
    Precision,
    PrecisionAtFixedRecall,
    PrecisionRecallCurve,
    Recall,
    RecallAtFixedPrecision,
    SensitivityAtSpecificity,
    Specificity,
    SpecificityAtSensitivity,
    StatScores,
)
from metrics_tpu_torch.detection import ModifiedPanopticQuality, PanopticQuality  # noqa: E402
from metrics_tpu_torch.image import (  # noqa: E402
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    StructuralSimilarityIndexMeasure,
)
from metrics_tpu_torch.regression import (  # noqa: E402
    MeanAbsoluteError,
    MeanSquaredError,
    PearsonCorrCoef,
    SpearmanCorrCoef,
)
from metrics_tpu_torch.retrieval import (  # noqa: E402
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
    RetrievalRPrecision,
)
from metrics_tpu_torch.wrappers import BootStrapper  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BootStrapper",
    "CalibrationError",
    "CatMetric",
    "CohenKappa",
    "CompositionalMetric",
    "ConfusionMatrix",
    "Dice",
    "ExactMatch",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "HingeLoss",
    "JaccardIndex",
    "LogAUC",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanMetric",
    "MeanSquaredError",
    "Metric",
    "MetricCollection",
    "MinMetric",
    "ModifiedPanopticQuality",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "NegativePredictiveValue",
    "PanopticQuality",
    "PeakSignalNoiseRatio",
    "PearsonCorrCoef",
    "Precision",
    "PrecisionAtFixedRecall",
    "PrecisionRecallCurve",
    "ROC",
    "Recall",
    "RecallAtFixedPrecision",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "RunningMean",
    "RunningSum",
    "SensitivityAtSpecificity",
    "SpearmanCorrCoef",
    "Specificity",
    "SpecificityAtSensitivity",
    "StatScores",
    "StructuralSimilarityIndexMeasure",
    "SumMetric",
    "__version__",
    "classification",
    "detection",
    "functional",
    "image",
    "ops",
    "parallel",
    "regression",
    "retrieval",
    "utils",
    "wrappers",
]
