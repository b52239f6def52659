"""Image metrics.

The names are those of ``metrics_tpu.image.__all__`` that are ported, in its
order.
"""

from metrics_tpu_torch.image.metrics import (
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    StructuralSimilarityIndexMeasure,
)

__all__ = [
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "StructuralSimilarityIndexMeasure",
]
