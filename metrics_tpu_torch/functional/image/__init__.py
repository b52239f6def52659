"""Functional image metrics.

The names are those of ``metrics_tpu.functional.image.__all__`` that are
ported, in its order.
"""

from metrics_tpu_torch.functional.image.metrics import (
    error_relative_global_dimensionless_synthesis,
    image_gradients,
    peak_signal_noise_ratio_with_blocked_effect,
    quality_with_no_reference,
    relative_average_spectral_error,
    root_mean_squared_error_using_sliding_window,
    spatial_correlation_coefficient,
    spatial_distortion_index,
    spectral_angle_mapper,
    spectral_distortion_index,
    total_variation,
    universal_image_quality_index,
    visual_information_fidelity,
)
from metrics_tpu_torch.functional.image.perceptual import (
    learned_perceptual_image_patch_similarity,
    perceptual_path_length,
)
from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
from metrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)

__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "learned_perceptual_image_patch_similarity",
    "perceptual_path_length",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "peak_signal_noise_ratio_with_blocked_effect",
    "quality_with_no_reference",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spatial_correlation_coefficient",
    "spatial_distortion_index",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "image_gradients",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
    "visual_information_fidelity",
]
