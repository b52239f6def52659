"""Correlation and variance-decomposition metrics (counterpart of ``metrics_tpu/regression/correlation.py``):
Pearson, concordance, Spearman, Kendall, R², relative squared error, explained variance, cosine similarity and
KL divergence."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from metrics_tpu_torch.functional.regression.concordance import _concordance_corrcoef_compute
from metrics_tpu_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from metrics_tpu_torch.functional.regression.explained_variance import (
    ALLOWED_MULTIOUTPUT,
    _explained_variance_compute,
    _explained_variance_fold,
    _explained_variance_update,
    _merge_moments,
)
from metrics_tpu_torch.functional.regression.kendall import (
    _kendall_corrcoef_update,
    kendall_rank_corrcoef,
)
from metrics_tpu_torch.functional.regression.kl_divergence import _kld_compute, _kld_update
from metrics_tpu_torch.functional.regression.pearson import (
    _final_aggregation,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from metrics_tpu_torch.functional.regression.r2 import (
    _r2_score_compute,
    _r2_score_update,
    _relative_squared_error_compute,
)
from metrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _is_traced
from metrics_tpu_torch.utils.compute import count_dtype
from metrics_tpu_torch.utils.data import dim_zero_cat

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "ExplainedVariance",
    "KLDivergence",
    "KendallRankCorrCoef",
    "PearsonCorrCoef",
    "R2Score",
    "RelativeSquaredError",
    "SpearmanCorrCoef",
]

Tensor = torch.Tensor


class PearsonCorrCoef(Metric):
    """Pearson correlation coefficient.

    The states are streaming moments reduced by ``dist_reduce_fx=None``: a
    sync gathers them to a stack with one row per rank, and ``compute`` folds
    the stack by Chan's pairwise merge (``_final_aggregation``).

    >>> metric = PearsonCorrCoef(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(0.9849)
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError("Expected argument `num_outputs` to be an int larger than 0")
        self.num_outputs = num_outputs
        shape = (num_outputs,) if num_outputs > 1 else ()
        for name in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"):
            self.add_state(name, torch.zeros(shape), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total,
            self.num_outputs,
        )

    def _sync_reduce(self) -> tuple:
        """The moments, with a stack of per-rank moments (after a sync) folded into one set."""
        if self.mean_x.ndim > (1 if self.num_outputs > 1 else 0):
            return _final_aggregation(self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total)
        return self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total

    def compute(self) -> Tensor:
        """Compute metric."""
        _, _, var_x, var_y, corr_xy, n_total = self._sync_reduce()
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)


class ConcordanceCorrCoef(PearsonCorrCoef):
    """Lin's concordance correlation coefficient, on Pearson's moments and their fold.

    >>> metric = ConcordanceCorrCoef(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(0.9768)
    """

    def compute(self) -> Tensor:
        """Compute metric."""
        mean_x, mean_y, var_x, var_y, corr_xy, n_total = self._sync_reduce()
        return _concordance_corrcoef_compute(mean_x, mean_y, var_x, var_y, corr_xy, n_total)


class SpearmanCorrCoef(Metric):
    """Spearman rank correlation coefficient; the samples are kept in "cat" list states.

    >>> metric = SpearmanCorrCoef(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(1.0000)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = _spearman_corrcoef_update(preds.to(torch.float32), target.to(torch.float32), self.num_outputs)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        """Compute metric."""
        return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))


class KendallRankCorrCoef(Metric):
    """Kendall's tau (variant ``"a"``, ``"b"`` or ``"c"``), with its p-value when ``t_test``; the samples are
    kept in "cat" list states and the pairs counted exactly at ``compute``.

    >>> metric = KendallRankCorrCoef(device="cpu")
    >>> metric.update(torch.tensor([2.5, 1.0, 4.0, 7.0]), torch.tensor([3.0, -0.5, 2.0, 1.0]))
    >>> metric.compute()
    tensor(0.)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        variant: str = "b",
        t_test: bool = False,
        alternative: Optional[str] = "two-sided",
        num_outputs: int = 1,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if variant not in ("a", "b", "c"):
            raise ValueError(f"Argument `variant` is expected to be one of 'a', 'b', 'c' but got {variant!r}")
        if not isinstance(t_test, bool):
            raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {type(t_test)}.")
        if t_test and alternative not in ("two-sided", "less", "greater"):
            raise ValueError("Argument `alternative` is expected to be one of 'two-sided', 'less' or 'greater'.")
        self.variant = variant
        self.t_test = t_test
        self.alternative = alternative if t_test else None
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = _kendall_corrcoef_update(preds.to(torch.float32), target.to(torch.float32),
                                                 self.num_outputs)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self):
        """Compute metric."""
        return kendall_rank_corrcoef(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.variant,
                                     self.t_test, self.alternative)


class R2Score(Metric):
    """Coefficient of determination, optionally adjusted, over one or several outputs.

    >>> metric = R2Score(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(0.9486)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_upper_bound = 1.0

    def __init__(
        self, num_outputs: int = 1, adjusted: int = 0, multioutput: str = "uniform_average", **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        if multioutput not in ALLOWED_MULTIOUTPUT:
            raise ValueError(
                "Invalid input to argument `multioutput`. Choose one of the following:"
                " ('raw_values', 'uniform_average', 'variance_weighted')"
            )
        self.multioutput = multioutput
        shape = (num_outputs,) if num_outputs > 1 else ()
        self.add_state("sum_squared_error", torch.zeros(shape), "sum")
        self.add_state("sum_error", torch.zeros(shape), "sum")
        self.add_state("residual", torch.zeros(shape), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Compute metric."""
        if not _is_traced(self.total) and int(self.total) < 2:
            raise ValueError("Needs at least two samples to calculate r2 score.")
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )


class RelativeSquaredError(Metric):
    """Relative squared error (its root with ``squared=False``), averaged over the outputs.

    >>> metric = RelativeSquaredError(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(0.0514)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, num_outputs: int = 1, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.squared = squared
        shape = (num_outputs,) if num_outputs > 1 else ()
        self.add_state("sum_squared_error", torch.zeros(shape), "sum")
        self.add_state("sum_error", torch.zeros(shape), "sum")
        self.add_state("residual", torch.zeros(shape), "sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + num_obs

    def compute(self) -> Tensor:
        """Compute metric."""
        return _relative_squared_error_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.squared
        )


_MOMENTS = ("num_obs", "mean_diff", "m2_diff", "mean_target", "m2_target")


class ExplainedVariance(Metric):
    """Explained variance, on the Welford moments of ``target - preds`` and of ``target``.

    The five moment states (``dist_reduce_fx=None``) start 0-d and take the
    outputs' shape at the first update. A sync, a merge or a ``forward`` stacks
    one set per rank or batch along a new first dimension, told apart by the
    count's dimensions; ``compute`` and the next ``update`` fold the stack in
    order by Chan's formulas (:meth:`_sync_reduce`).

    >>> metric = ExplainedVariance(device="cpu")
    >>> metric.update(torch.tensor([2.5, 0.0, 2., 8.]), torch.tensor([3., -0.5, 2., 7.]))
    >>> metric.compute()
    tensor(0.9572)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_upper_bound = 1.0

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if multioutput not in ALLOWED_MULTIOUTPUT:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}"
            )
        self.multioutput = multioutput
        for name in _MOMENTS:
            self.add_state(name, torch.zeros(()), dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        nb, mb_diff, m2b_diff, mb_target, m2b_target = _explained_variance_update(preds, target)
        n, mean_diff, m2_diff, mean_target, m2_target = self._sync_reduce()
        n_new, self.mean_diff, self.m2_diff = _merge_moments(n, mean_diff, m2_diff, nb, mb_diff, m2b_diff)
        _, self.mean_target, self.m2_target = _merge_moments(n, mean_target, m2_target, nb, mb_target, m2b_target)
        self.num_obs = n_new

    def _merge_state_dicts(
        self, state_a: Dict[str, Any], state_b: Dict[str, Any], count_a: int, count_b: int
    ) -> Dict[str, Any]:
        """Stack the two sides' moment sets, one row per set. A side's count is 0-d unless it is a stack
        already (the generic merge would read one set of several outputs as a stack), and a side that never
        updated holds 0-d moments, broadcast to the other side's outputs."""
        out = {}
        for key in _MOMENTS:
            a, b = (s[key] if s["num_obs"].ndim else s[key].unsqueeze(0) for s in (state_a, state_b))
            width = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
            out[key] = torch.cat([a.expand(a.shape[:1] + width), b.expand(b.shape[:1] + width)])
        return out

    def _sync_reduce(self) -> tuple:
        """The moments, with a stack of per-rank (or per-batch) moment sets folded into one."""
        if self.num_obs.ndim > 0:
            return _explained_variance_fold(self.num_obs, self.mean_diff, self.m2_diff, self.mean_target,
                                            self.m2_target)
        return self.num_obs, self.mean_diff, self.m2_diff, self.mean_target, self.m2_target

    def compute(self) -> Tensor:
        """Compute metric."""
        num_obs, mean_diff, m2_diff, mean_target, m2_target = self._sync_reduce()
        return _explained_variance_compute(num_obs, mean_diff, m2_diff, mean_target, m2_target, self.multioutput)


class CosineSimilarity(Metric):
    """Cosine similarity of each pair of rows, reduced by ``"sum"``, ``"mean"`` or ``"none"``; the rows are
    kept in "cat" list states.

    >>> metric = CosineSimilarity(reduction='mean', device="cpu")
    >>> metric.update(torch.tensor([[1., 2., 3., 4.]]), torch.tensor([[1., 2., 3., 4.]]))
    >>> metric.compute()
    tensor(1.)
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction not in ("sum", "mean", "none", None):
            raise ValueError(f"Expected reduction to be one of ('sum', 'mean', 'none', None) but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = _cosine_similarity_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Tensor:
        """Compute metric."""
        return _cosine_similarity_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)


class KLDivergence(Metric):
    """KL divergence of Q from P, row by row, reduced by ``"mean"``, ``"sum"`` or ``"none"``; with
    ``log_prob`` the inputs are log-probabilities.

    >>> metric = KLDivergence(device="cpu")
    >>> metric.update(torch.tensor([[0.36, 0.48, 0.16]]), torch.tensor([[1/3, 1/3, 1/3]]))
    >>> metric.compute()
    tensor(0.0853)
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        self.log_prob = log_prob
        if reduction not in ("mean", "sum", "none", None):
            raise ValueError("Expected argument `reduction` to be one of ('mean', 'sum', 'none', None)")
        self.reduction = reduction
        if reduction in ("mean", "sum"):
            self.add_state("measures", torch.zeros(()), "sum")
        else:
            self.add_state("measures", [], "cat")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), "sum")

    def update(self, p: Tensor, q: Tensor) -> None:
        """Update state with two probability distributions."""
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction in ("none", None):
            self.measures.append(measures)
        else:
            self.measures = self.measures + measures.sum()
        self.total = self.total + total

    def compute(self) -> Tensor:
        """Compute metric."""
        if self.reduction in ("none", None):
            return _kld_compute(dim_zero_cat(self.measures), self.total, self.reduction)
        return self.measures / self.total if self.reduction == "mean" else self.measures
