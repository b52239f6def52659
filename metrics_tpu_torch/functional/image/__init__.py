"""Functional image metrics."""

from metrics_tpu_torch.functional.image.ssim import structural_similarity_index_measure

__all__ = ["structural_similarity_index_measure"]
