"""Image metrics."""

from metrics_tpu_torch.image.metrics import StructuralSimilarityIndexMeasure

__all__ = ["StructuralSimilarityIndexMeasure"]
