"""Sum-state regression metrics (counterpart of ``metrics_tpu/regression/basics.py``): MSE, MAE, MSLE, the
three percentage errors, log-cosh, Minkowski, Tweedie deviance, CSI and NRMSE."""

from __future__ import annotations

from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.regression.csi import (
    _critical_success_index_compute,
    _critical_success_index_update,
)
from metrics_tpu_torch.functional.regression.explained_variance import _batch_moments, _merge_moments
from metrics_tpu_torch.functional.regression.log_cosh import _log_cosh_error_compute, _log_cosh_error_update
from metrics_tpu_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from metrics_tpu_torch.functional.regression.mape import (
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
    _symmetric_mean_absolute_percentage_error_update,
    _weighted_mean_absolute_percentage_error_compute,
    _weighted_mean_absolute_percentage_error_update,
)
from metrics_tpu_torch.functional.regression.minkowski import _minkowski_distance_compute, _minkowski_distance_update
from metrics_tpu_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from metrics_tpu_torch.functional.regression.msle import (
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
)
from metrics_tpu_torch.functional.regression.nrmse import _normalized_root_mean_squared_error_compute
from metrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

__all__ = [
    "CriticalSuccessIndex",
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "MinkowskiDistance",
    "NormalizedRootMeanSquaredError",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]

Tensor = torch.Tensor


class MeanSquaredError(Metric):
    """Mean squared error, or its root with ``squared=False``.

    >>> metric = MeanSquaredError(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(0.3750)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("sum_squared_error", torch.zeros(num_outputs) if num_outputs > 1 else torch.zeros(()), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_squared_error, num_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Compute metric."""
        return _mean_squared_error_compute(self.sum_squared_error, self.total, self.squared)


class MeanAbsoluteError(Metric):
    """Mean absolute error.

    >>> metric = MeanAbsoluteError(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(0.5000)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("sum_abs_error", torch.zeros(num_outputs) if num_outputs > 1 else torch.zeros(()), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_abs_error, num_obs = _mean_absolute_error_update(preds, target, self.num_outputs)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Compute metric."""
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)


class MeanSquaredLogError(Metric):
    """Mean squared log error.

    >>> metric = MeanSquaredLogError(device="cpu")
    >>> metric.update(torch.tensor([0., 1., 2., 3.]), torch.tensor([0., 1., 2., 2.]))
    >>> metric.compute()
    tensor(0.0207)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", torch.zeros(()), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_squared_log_error, num_obs = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + sum_squared_log_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Compute metric."""
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)


class MeanAbsolutePercentageError(Metric):
    """Mean absolute percentage error; a target's magnitude is clamped below at 1.17e-06.

    >>> metric = MeanAbsolutePercentageError(device="cpu")
    >>> metric.update(torch.tensor([0.5, 1., 2., 8.]), torch.tensor([1., 2., 2., 4.]))
    >>> metric.compute()
    tensor(0.5000)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", torch.zeros(()), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Compute metric."""
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)


class SymmetricMeanAbsolutePercentageError(Metric):
    """Symmetric mean absolute percentage error.

    >>> metric = SymmetricMeanAbsolutePercentageError(device="cpu")
    >>> metric.update(torch.tensor([0.5, 1., 2., 8.]), torch.tensor([1., 2., 2., 4.]))
    >>> metric.compute()
    tensor(0.5000)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", torch.zeros(()), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Compute metric."""
        return self.sum_abs_per_error / self.total


class WeightedMeanAbsolutePercentageError(Metric):
    """Weighted mean absolute percentage error: the summed absolute error over the summed absolute target.

    >>> metric = WeightedMeanAbsolutePercentageError(device="cpu")
    >>> metric.update(torch.tensor([0.5, 1., 2., 8.]), torch.tensor([1., 2., 2., 4.]))
    >>> metric.compute()
    tensor(0.6111)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", torch.zeros(()), "sum")
        self.add_state("sum_scale", torch.zeros(()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.sum_scale = self.sum_scale + sum_scale

    def compute(self) -> Tensor:
        """Compute metric."""
        return _weighted_mean_absolute_percentage_error_compute(self.sum_abs_error, self.sum_scale)


class LogCoshError(Metric):
    """Log-cosh error, one value per output.

    >>> metric = LogCoshError(device="cpu")
    >>> metric.update(torch.tensor([3.0, 5.0, 2.5, 7.0]), torch.tensor([2.5, 5.0, 4.0, 8.0]))
    >>> metric.compute()
    tensor(0.3523)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("sum_log_cosh_error", torch.zeros(num_outputs), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_log_cosh_error, num_obs = _log_cosh_error_update(preds, target, self.num_outputs)
        self.sum_log_cosh_error = self.sum_log_cosh_error + sum_log_cosh_error
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Compute metric."""
        return _log_cosh_error_compute(self.sum_log_cosh_error, self.total)


class MinkowskiDistance(Metric):
    """Minkowski distance of order ``p`` (at least 1).

    >>> metric = MinkowskiDistance(p=3, device="cpu")
    >>> metric.update(torch.tensor([0.0, 1.0, 3.0, 2.0]), torch.tensor([1.0, 2.0, 3.0, 1.0]))
    >>> metric.compute()
    tensor(1.4422)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(p, (float, int)) and p >= 1):
            raise TPUMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")
        self.p = p
        self.add_state("minkowski_dist_sum", torch.zeros(()), "sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        """Update state with predictions and targets."""
        self.minkowski_dist_sum = self.minkowski_dist_sum + _minkowski_distance_update(preds, targets, self.p)

    def compute(self) -> Tensor:
        """Compute metric."""
        return _minkowski_distance_compute(self.minkowski_dist_sum, self.p)


class TweedieDevianceScore(Metric):
    """Mean Tweedie deviance of the given power (not in (0, 1)).

    >>> metric = TweedieDevianceScore(power=2, device="cpu")
    >>> metric.update(torch.tensor([4.0, 3.0, 2.0, 1.0]), torch.tensor([1.0, 2.0, 3.0, 4.0]))
    >>> metric.compute()
    tensor(1.2083)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", torch.zeros(()), "sum")
        self.add_state("num_observations", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, targets: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> Tensor:
        """Compute metric."""
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)


class CriticalSuccessIndex(Metric):
    """Critical success index at ``threshold``.

    With ``keep_sequence_dim`` (the index of a dimension, e.g. the lead time of
    a nowcast), each update keeps one count per entry of that dimension in
    "cat" list states, and ``compute`` gives one CSI per kept entry of every
    update; without it the counts are summed int64 states.

    >>> metric = CriticalSuccessIndex(0.5, device="cpu")
    >>> metric.update(torch.tensor([[0.2, 0.7], [0.9, 0.3]]), torch.tensor([[0.4, 0.2], [0.8, 0.6]]))
    >>> metric.compute()
    tensor(0.3333)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, threshold: float, keep_sequence_dim: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(threshold, (int, float)):
            raise ValueError(f"Expected argument `threshold` to be a float but got {threshold}")
        self.threshold = float(threshold)
        if keep_sequence_dim is None:
            self.keep_sequence_dim = None
            for name in ("hits", "misses", "false_alarms"):
                self.add_state(name, torch.zeros((), dtype=count_dtype()), "sum")
        else:
            if not isinstance(keep_sequence_dim, int) or keep_sequence_dim < 0:
                raise ValueError(f"Expected keep_sequence_dim to be int or None but got {keep_sequence_dim}")
            self.keep_sequence_dim = keep_sequence_dim
            for name in ("hits", "misses", "false_alarms"):
                self.add_state(name, [], "cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        if self.keep_sequence_dim:
            preds = torch.movedim(preds, self.keep_sequence_dim, 0)
            target = torch.movedim(target, self.keep_sequence_dim, 0)
        hits, misses, false_alarms = _critical_success_index_update(
            preds, target, self.threshold, 0 if self.keep_sequence_dim is not None else None
        )
        if self.keep_sequence_dim is None:
            self.hits = self.hits + hits
            self.misses = self.misses + misses
            self.false_alarms = self.false_alarms + false_alarms
        else:
            self.hits.append(hits)
            self.misses.append(misses)
            self.false_alarms.append(false_alarms)

    def compute(self) -> Tensor:
        """Compute metric."""
        return _critical_success_index_compute(dim_zero_cat(self.hits), dim_zero_cat(self.misses),
                                               dim_zero_cat(self.false_alarms))


class NormalizedRootMeanSquaredError(Metric):
    """RMSE over the target's mean, range, standard deviation or l2 norm.

    The normaliser is itself a streaming state: ``"range"`` keeps the min and
    max, the others keep the target's Welford moments ``(n, mean, m2)``
    (``dist_reduce_fx=None``), merged by Chan's formulas; a sync gathers one set
    per rank, and ``compute`` folds them (:meth:`_sync_reduce`). ``"l2"`` is
    ``sqrt(m2 + n mean**2)``, a sum of non-negative terms.

    >>> metric = NormalizedRootMeanSquaredError(device="cpu")
    >>> metric.update(torch.tensor([0., 1, 2, 3]), torch.tensor([0., 1, 2, 2]))
    >>> metric.compute()
    tensor(0.4000)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, normalization: str = "mean", num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if normalization not in ("mean", "range", "std", "l2"):
            raise ValueError(
                f"Argument `normalization` should be either 'mean', 'range', 'std' or 'l2', but got {normalization}"
            )
        self.normalization = normalization
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")
        self.num_outputs = num_outputs
        shape = (num_outputs,) if num_outputs > 1 else ()
        self.add_state("sum_squared_error", torch.zeros(shape), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")
        self.add_state("num_obs", torch.zeros(()), dist_reduce_fx=None)
        self.add_state("target_mean", torch.zeros(shape), dist_reduce_fx=None)
        self.add_state("target_m2", torch.zeros(shape), dist_reduce_fx=None)
        self.add_state("min_val", torch.full(shape, float("inf")), "min")
        self.add_state("max_val", torch.full(shape, float("-inf")), "max")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_squared_error, num_obs = _mean_squared_error_update(preds, target, self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + num_obs
        t = (target.reshape(-1) if self.num_outputs == 1 else target).to(torch.float32)
        mean_b, m2_b = _batch_moments(t)
        # moments stacked by a forward's merge are folded before the batch joins them
        n, mean, m2 = self._sync_reduce()
        self.num_obs, self.target_mean, self.target_m2 = _merge_moments(n, mean, m2, t.shape[0], mean_b, m2_b)
        self.min_val = torch.minimum(self.min_val, t.amin(0))
        self.max_val = torch.maximum(self.max_val, t.amax(0))

    def _sync_reduce(self) -> tuple:
        """The target's moments, with a stack of per-rank moments (after a sync or a merge) folded into one."""
        n, mean, m2 = self.num_obs, self.target_mean, self.target_m2
        if n.ndim > 0:
            nf, meanf, m2f = n[0], mean[0], m2[0]
            for i in range(1, n.shape[0]):
                nf, meanf, m2f = _merge_moments(nf, meanf, m2f, n[i], mean[i], m2[i])
            return nf, meanf, m2f
        return n, mean, m2

    def compute(self) -> Tensor:
        """Compute metric."""
        num_obs, target_mean, target_m2 = self._sync_reduce()
        if self.normalization == "mean":
            denom = target_mean
        elif self.normalization == "range":
            denom = self.max_val - self.min_val
        elif self.normalization == "std":
            denom = torch.sqrt(target_m2 / num_obs)
        else:
            denom = torch.sqrt(target_m2 + num_obs * target_mean**2)
        return _normalized_root_mean_squared_error_compute(self.sum_squared_error, self.total, denom)
