"""The port's constructors for the JAX package's fleet cases (``analysis/fleet_contracts.fleet_cases``).

Each entry builds the port's counterpart of one registry class on the CPU,
with the configuration the JAX package's ``observe/costs.py`` registry gives
it. The batches come from the JAX case's own batch function (same seeded
``RandomState``), converted to tensors, so that both packages see the same
numbers. This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

import metrics_tpu_torch as M
import metrics_tpu_torch.classification as C
import metrics_tpu_torch.segmentation as S

_C = 4
_CPU = {"device": "cpu"}


def _ctors() -> Dict[str, Callable[[], Any]]:
    return {
        "BinaryAccuracy": lambda: C.BinaryAccuracy(**_CPU),
        "BinaryPrecision": lambda: C.BinaryPrecision(**_CPU),
        "BinaryRecall": lambda: C.BinaryRecall(**_CPU),
        "BinaryF1Score": lambda: C.BinaryF1Score(**_CPU),
        "BinarySpecificity": lambda: C.BinarySpecificity(**_CPU),
        "BinaryStatScores": lambda: C.BinaryStatScores(**_CPU),
        "BinaryHammingDistance": lambda: C.BinaryHammingDistance(**_CPU),
        "BinaryCohenKappa": lambda: C.BinaryCohenKappa(**_CPU),
        "BinaryMatthewsCorrCoef": lambda: C.BinaryMatthewsCorrCoef(**_CPU),
        "BinaryJaccardIndex": lambda: C.BinaryJaccardIndex(**_CPU),
        "BinaryHingeLoss": lambda: C.BinaryHingeLoss(**_CPU),
        "BinaryAUROC": lambda: C.BinaryAUROC(thresholds=16, **_CPU),
        "BinaryAveragePrecision": lambda: C.BinaryAveragePrecision(thresholds=16, **_CPU),
        "BinaryNegativePredictiveValue": lambda: C.BinaryNegativePredictiveValue(**_CPU),
        "MulticlassAccuracy": lambda: C.MulticlassAccuracy(num_classes=_C, **_CPU),
        "MulticlassPrecision": lambda: C.MulticlassPrecision(num_classes=_C, **_CPU),
        "MulticlassRecall": lambda: C.MulticlassRecall(num_classes=_C, **_CPU),
        "MulticlassF1Score": lambda: C.MulticlassF1Score(num_classes=_C, **_CPU),
        "MulticlassConfusionMatrix": lambda: C.MulticlassConfusionMatrix(num_classes=_C, **_CPU),
        "MulticlassCohenKappa": lambda: C.MulticlassCohenKappa(num_classes=_C, **_CPU),
        "MulticlassAUROC": lambda: C.MulticlassAUROC(num_classes=_C, thresholds=16, **_CPU),
        "MulticlassExactMatch": lambda: C.MulticlassExactMatch(num_classes=_C, **_CPU),
        "MultilabelFBetaScore": lambda: C.MultilabelFBetaScore(beta=2.0, num_labels=_C, **_CPU),
        "MultilabelAccuracy": lambda: C.MultilabelAccuracy(num_labels=_C, **_CPU),
        "MeanSquaredError": lambda: M.MeanSquaredError(**_CPU),
        "MeanAbsoluteError": lambda: M.MeanAbsoluteError(**_CPU),
        "MeanSquaredLogError": lambda: M.MeanSquaredLogError(**_CPU),
        "MeanAbsolutePercentageError": lambda: M.MeanAbsolutePercentageError(**_CPU),
        "SymmetricMeanAbsolutePercentageError": lambda: M.SymmetricMeanAbsolutePercentageError(**_CPU),
        "WeightedMeanAbsolutePercentageError": lambda: M.WeightedMeanAbsolutePercentageError(**_CPU),
        "ExplainedVariance": lambda: M.ExplainedVariance(**_CPU),
        "R2Score": lambda: M.R2Score(**_CPU),
        "PearsonCorrCoef": lambda: M.PearsonCorrCoef(**_CPU),
        "ConcordanceCorrCoef": lambda: M.ConcordanceCorrCoef(**_CPU),
        "MinkowskiDistance": lambda: M.MinkowskiDistance(p=3, **_CPU),
        "LogCoshError": lambda: M.LogCoshError(**_CPU),
        "TweedieDevianceScore": lambda: M.TweedieDevianceScore(power=1.5, **_CPU),
        "RelativeSquaredError": lambda: M.RelativeSquaredError(**_CPU),
        "NormalizedRootMeanSquaredError": lambda: M.NormalizedRootMeanSquaredError(**_CPU),
        "KLDivergence": lambda: M.KLDivergence(**_CPU),
        "MeanMetric": lambda: M.MeanMetric(**_CPU),
        "SumMetric": lambda: M.SumMetric(**_CPU),
        "MaxMetric": lambda: M.MaxMetric(**_CPU),
        "MinMetric": lambda: M.MinMetric(**_CPU),
        "PeakSignalNoiseRatio": lambda: M.PeakSignalNoiseRatio(data_range=1.0, **_CPU),
        "StructuralSimilarityIndexMeasure": lambda: M.StructuralSimilarityIndexMeasure(data_range=1.0, **_CPU),
        "TotalVariation": lambda: M.TotalVariation(**_CPU),
        "SignalNoiseRatio": lambda: M.SignalNoiseRatio(**_CPU),
        "ScaleInvariantSignalNoiseRatio": lambda: M.ScaleInvariantSignalNoiseRatio(**_CPU),
        "ScaleInvariantSignalDistortionRatio": lambda: M.ScaleInvariantSignalDistortionRatio(**_CPU),
        "MeanIoU": lambda: S.MeanIoU(num_classes=_C, input_format="index", **_CPU),
        "GeneralizedDiceScore": lambda: S.GeneralizedDiceScore(num_classes=_C, input_format="index", **_CPU),
        "Perplexity": lambda: M.Perplexity(**_CPU),
        "DDSketch": lambda: M.DDSketch(num_buckets=512, **_CPU),
        "HyperLogLog": lambda: M.HyperLogLog(p=8, **_CPU),
        "ReservoirSample": lambda: M.ReservoirSample(k=16, **_CPU),
        "StreamingAUROC": lambda: M.StreamingAUROC(num_bins=128, **_CPU),
        "StreamingCalibrationError": lambda: M.StreamingCalibrationError(num_bins=10, **_CPU),
        "TimeDecayed": lambda: M.TimeDecayed(M.MeanMetric(nan_strategy="disable", **_CPU), half_life_s=60.0),
        "TumblingWindow": lambda: M.TumblingWindow(M.SumMetric(nan_strategy="disable", **_CPU), pane_s=1.0,
                                                   n_panes=8),
        "DecayedDDSketch": lambda: M.DecayedDDSketch(half_life_s=60.0, num_buckets=512, **_CPU),
        "DecayedHLL": lambda: M.DecayedHLL(half_life_s=60.0, p=8, **_CPU),
        "PSI": lambda: M.PSI(lo=0.0, hi=1.0, num_bins=32, **_CPU),
        "KSDistance": lambda: M.KSDistance(lo=0.0, hi=1.0, num_bins=32, **_CPU),
        "CUSUM": lambda: M.CUSUM(target=0.5, k=0.1, h=5.0, **_CPU),
    }


PORT_CTORS = _ctors()


def to_torch(value: Any) -> Any:
    """A JAX case's batch value as the port takes it: arrays become CPU tensors, anything else stays."""
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        return torch.from_numpy(np.array(value))
    return value
