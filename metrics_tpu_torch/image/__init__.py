"""Image metrics.

The names are those of ``metrics_tpu.image.__all__`` that are ported, in its
order.
"""

from metrics_tpu_torch.image.generative import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    MemorizationInformedFrechetInceptionDistance,
)
from metrics_tpu_torch.image.lpips import LearnedPerceptualImagePatchSimilarity, PerceptualPathLength
from metrics_tpu_torch.image.metrics import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    PeakSignalNoiseRatioWithBlockedEffect,
    QualityWithNoReference,
    RelativeAverageSpectralError,
    RootMeanSquaredErrorUsingSlidingWindow,
    SpatialCorrelationCoefficient,
    SpatialDistortionIndex,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    TotalVariation,
    UniversalImageQualityIndex,
    VisualInformationFidelity,
)

__all__ = [
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MemorizationInformedFrechetInceptionDistance",
    "PerceptualPathLength",
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "QualityWithNoReference",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpatialCorrelationCoefficient",
    "SpatialDistortionIndex",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
]
