"""Modular audio metrics (counterpart of ``metrics_tpu/audio``): the signal-level metrics on the device, STOI
and SRMR with host stages, and PESQ, DNSMOS and NISQA gated on their optional packages."""

from metrics_tpu_torch.audio.gated import (
    DeepNoiseSuppressionMeanOpinionScore,
    NonIntrusiveSpeechQualityAssessment,
    PerceptualEvaluationSpeechQuality,
    ShortTimeObjectiveIntelligibility,
    SpeechReverberationModulationEnergyRatio,
)
from metrics_tpu_torch.audio.metrics import (
    ComplexScaleInvariantSignalNoiseRatio,
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    SignalDistortionRatio,
    SignalNoiseRatio,
    SourceAggregatedSignalDistortionRatio,
)

__all__ = [
    "DeepNoiseSuppressionMeanOpinionScore",
    "NonIntrusiveSpeechQualityAssessment",
    "PerceptualEvaluationSpeechQuality",
    "ShortTimeObjectiveIntelligibility",
    "SpeechReverberationModulationEnergyRatio",
    "ComplexScaleInvariantSignalNoiseRatio",
    "PermutationInvariantTraining",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SourceAggregatedSignalDistortionRatio",
]
