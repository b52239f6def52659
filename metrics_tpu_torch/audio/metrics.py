"""Modular signal-level audio metrics (counterpart of ``metrics_tpu/audio/metrics.py``): a sum of the values
(of the default float type) and their count (``count_dtype()``), updated on the metric's device without a
host read, except PIT from three speakers, whose assignment reads the metric matrix once."""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.metrics import (
    complex_scale_invariant_signal_noise_ratio,
    permutation_invariant_training,
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    signal_distortion_ratio,
    signal_noise_ratio,
    source_aggregated_signal_distortion_ratio,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype


class _AveragedAudioMetric(Metric):
    """Shared plumbing: Σ metric values and their count."""

    is_differentiable = True
    full_state_update = False
    sum_value: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_value", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:  # pragma: no cover - abstract
        raise NotImplementedError

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        values = self._metric(preds, target)
        self.sum_value = self.sum_value + values.sum()
        self.total = self.total + values.numel()

    def compute(self) -> Tensor:
        """Compute metric."""
        return (self.sum_value / self.total).to(torch.float32)


class SignalNoiseRatio(_AveragedAudioMetric):
    """SNR.

    >>> metric = SignalNoiseRatio(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
    >>> round(float(metric.compute()), 4)
    16.1805
    """

    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_noise_ratio(preds, target, self.zero_mean)


class ScaleInvariantSignalDistortionRatio(_AveragedAudioMetric):
    """SI-SDR.

    >>> metric = ScaleInvariantSignalDistortionRatio(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
    >>> round(float(metric.compute()), 4)
    18.403
    """

    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_distortion_ratio(preds, target, self.zero_mean)


class ScaleInvariantSignalNoiseRatio(_AveragedAudioMetric):
    """SI-SNR."""

    higher_is_better = True

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_noise_ratio(preds, target)


class ComplexScaleInvariantSignalNoiseRatio(_AveragedAudioMetric):
    """C-SI-SNR."""

    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return complex_scale_invariant_signal_noise_ratio(preds, target, self.zero_mean)


class SignalDistortionRatio(_AveragedAudioMetric):
    """SDR with the optimal distortion filter."""

    higher_is_better = True

    def __init__(
        self,
        use_cg_iter: Any = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Any = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )


class SourceAggregatedSignalDistortionRatio(_AveragedAudioMetric):
    """SA-SDR."""

    higher_is_better = True

    def __init__(self, scale_invariant: bool = True, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(scale_invariant, bool):
            raise ValueError(f"Expected argument `scale_invariant` to be a bool, but got {scale_invariant}")
        self.scale_invariant = scale_invariant
        self.zero_mean = zero_mean

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return source_aggregated_signal_distortion_ratio(preds, target, self.scale_invariant, self.zero_mean)


_BASE_KWARGS = ("device", "compute_on_cpu", "dist_sync_on_step", "process_group", "dist_sync_fn",
                "distributed_available_fn", "sync_on_compute", "compute_with_cache", "jit_update", "donate_states")


class PermutationInvariantTraining(_AveragedAudioMetric):
    """PIT: the mean best-permutation value of ``metric_func``; keyword arguments other than the metric
    runtime's go to ``metric_func``.

    >>> import numpy as np
    >>> from metrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
    >>> rng = np.random.RandomState(42)
    >>> target = torch.from_numpy(rng.randn(2, 2, 100).astype(np.float32))
    >>> metric = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, device="cpu")
    >>> metric.update(target.flip(1), target)
    >>> float(metric.compute()) > 30
    True
    """

    higher_is_better = True

    def __init__(
        self,
        metric_func: Callable,
        mode: str = "speaker-wise",
        eval_func: str = "max",
        **kwargs: Any,
    ) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in _BASE_KWARGS}
        super().__init__(**base_kwargs)
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.metric_kwargs = kwargs

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        best_metric, _ = permutation_invariant_training(
            preds, target, self.metric_func, self.mode, self.eval_func, **self.metric_kwargs
        )
        return best_metric
