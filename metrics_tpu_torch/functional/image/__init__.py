"""Functional image metrics.

The names are those of ``metrics_tpu.functional.image.__all__`` that are
ported, in its order.
"""

from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
from metrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)

__all__ = [
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "structural_similarity_index_measure",
]
