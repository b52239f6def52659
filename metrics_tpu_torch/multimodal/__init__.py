"""Multimodal metrics (counterpart of ``metrics_tpu/multimodal``)."""

from metrics_tpu_torch.multimodal.clip_score import CLIPImageQualityAssessment, CLIPScore

__all__ = ["CLIPImageQualityAssessment", "CLIPScore"]
