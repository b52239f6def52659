"""Functional audio metrics (counterpart of ``metrics_tpu/functional/audio``), computed on the inputs'
device."""

from metrics_tpu_torch.functional.audio.srmr import (
    speech_reverberation_modulation_energy_ratio,
)
from metrics_tpu_torch.functional.audio.gated_fn import (
    deep_noise_suppression_mean_opinion_score,
    non_intrusive_speech_quality_assessment,
    perceptual_evaluation_speech_quality,
)
from metrics_tpu_torch.functional.audio.metrics import (
    complex_scale_invariant_signal_noise_ratio,
    permutation_invariant_training,
    pit_permutate,
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    signal_distortion_ratio,
    signal_noise_ratio,
    source_aggregated_signal_distortion_ratio,
)
from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility

__all__ = [
    "complex_scale_invariant_signal_noise_ratio",
    "deep_noise_suppression_mean_opinion_score",
    "non_intrusive_speech_quality_assessment",
    "perceptual_evaluation_speech_quality",
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "short_time_objective_intelligibility",
    "signal_distortion_ratio",
    "signal_noise_ratio",
    "source_aggregated_signal_distortion_ratio",
    "speech_reverberation_modulation_energy_ratio",
]
