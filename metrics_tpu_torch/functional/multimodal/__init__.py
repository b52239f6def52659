"""Functional multimodal metrics (counterpart of ``metrics_tpu/functional/multimodal``)."""

from metrics_tpu_torch.functional.multimodal.clip_iqa import clip_image_quality_assessment
from metrics_tpu_torch.functional.multimodal.clip_score import clip_score

__all__ = ["clip_image_quality_assessment", "clip_score"]
