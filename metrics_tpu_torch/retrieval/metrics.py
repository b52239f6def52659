"""The retrieval metrics over the one sorted view (counterpart of ``metrics_tpu/retrieval/metrics.py``).

Every metric is a few segment sums over :class:`~metrics_tpu_torch.retrieval.base.GroupedQueries`;
no Python loop runs over the queries. ``plot`` is not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.retrieval.base import (
    GroupedQueries,
    RetrievalMetric,
    _segment_min,
    _segment_sum,
    shared_grouped_view,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor

__all__ = [
    "RetrievalAUROC",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
]


def _check_top_k(top_k: Optional[int]) -> Optional[int]:
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")
    return top_k


class _TopKRetrievalMetric(RetrievalMetric):
    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation: Any = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        self.top_k = _check_top_k(top_k)

    def _k_mask(self, gq: GroupedQueries) -> Tensor:
        if self.top_k is None:
            return torch.ones_like(gq.pos)
        return (gq.pos < self.top_k).to(torch.float32)

    def _k_per_group(self, gq: GroupedQueries) -> Tensor:
        if self.top_k is None:
            return gq.n_docs
        return torch.full_like(gq.n_docs, float(self.top_k))


class RetrievalMAP(_TopKRetrievalMetric):
    """Mean average precision over the queries.

    >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
    >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
    >>> target = torch.tensor([False, False, True, False, True, False, True])
    >>> rmap = RetrievalMAP(device="cpu")
    >>> rmap.update(preds, target, indexes=indexes)
    >>> rmap.compute()
    tensor(0.7917)
    """

    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:
        km = self._k_mask(gq)
        prec_at_i = gq.rel_cum / (gq.pos + 1.0)
        num = gq.seg_sum(prec_at_i * gq.rel * km)
        return _safe_divide(num, gq.seg_sum(gq.rel * km))


class RetrievalMRR(_TopKRetrievalMetric):
    """Mean reciprocal rank of the first relevant document.

    >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
    >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
    >>> target = torch.tensor([False, False, True, False, True, False, True])
    >>> mrr = RetrievalMRR(device="cpu")
    >>> mrr.update(preds, target, indexes=indexes)
    >>> mrr.compute()
    tensor(0.7500)
    """

    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:
        km = self._k_mask(gq)
        first_rel = gq.seg_min(torch.where((gq.rel > 0) & (km > 0), gq.pos + 1.0, torch.inf))
        finite = torch.isfinite(first_rel)
        return torch.where(finite, 1.0 / torch.where(finite, first_rel, 1.0), 0.0)


class RetrievalPrecision(_TopKRetrievalMetric):
    """Precision@k over the queries; ``adaptive_k`` caps k at each query's document count."""

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, adaptive_k: bool = False, aggregation: Any = "mean",
                 **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, top_k, aggregation, **kwargs)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:
        k = self._k_per_group(gq)
        if self.adaptive_k:
            k = torch.minimum(k, gq.n_docs)
        hits = gq.seg_sum(gq.rel * (gq.pos < k[gq.group_id]))
        return _safe_divide(hits, k)


class RetrievalRecall(_TopKRetrievalMetric):
    """Recall@k over the queries."""

    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:
        return _safe_divide(gq.seg_sum(gq.rel * self._k_mask(gq)), gq.n_rel)


class RetrievalFallOut(_TopKRetrievalMetric):
    """Fall-out@k over the queries; here an empty query is one with no non-relevant document."""

    higher_is_better = False
    _empty_error_msg = "`compute` method was provided with a query with no negative target."

    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:
        hits = gq.seg_sum((1.0 - gq.rel) * self._k_mask(gq))
        return _safe_divide(hits, gq.n_docs - gq.n_rel)

    def _empty_mask(self, gq: GroupedQueries) -> Tensor:
        return (gq.n_docs - gq.n_rel) == 0


class RetrievalHitRate(_TopKRetrievalMetric):
    """Hit-rate@k over the queries."""

    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:
        return (gq.seg_sum(gq.rel * self._k_mask(gq)) > 0).to(torch.float32)


class RetrievalRPrecision(RetrievalMetric):
    """R-precision over the queries: precision at each query's number of relevant documents."""

    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:
        hits = gq.seg_sum(gq.rel * (gq.pos < gq.n_rel[gq.group_id]))
        return _safe_divide(hits, gq.n_rel)


class RetrievalNormalizedDCG(_TopKRetrievalMetric):
    """NDCG@k over the queries, with graded relevance."""

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation: Any = "mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, top_k, aggregation, **kwargs)
        self.allow_non_binary_target = True

    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:
        km = self._k_mask(gq)
        discount = 1.0 / torch.log2(gq.pos + 2.0)
        dcg = gq.seg_sum(gq.graded * discount * km)
        idcg = gq.seg_sum(gq.ideal_graded * discount * km)
        return _safe_divide(dcg, idcg)


class RetrievalAUROC(_TopKRetrievalMetric):
    """AUROC per query over its top k, as the rank U-statistic: each relevant document is credited with
    the non-relevant ones ranked below it, and half of those that tie with its score."""

    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:
        km = self._k_mask(gq)
        rel = gq.rel * km
        nonrel = (1.0 - gq.rel) * km
        g, pred = gq.group_id, gq.preds
        n = pred.shape[0]
        # runs of equal score within a query (the rows are sorted by query, then score)
        new_run = torch.ones(n, dtype=torch.bool, device=pred.device)
        new_run[1:] = (g[1:] != g[:-1]) | (pred[1:] != pred[:-1])
        run_id = torch.cumsum(new_run, 0) - 1
        nonrel_in_run = _segment_sum(nonrel, run_id, n)
        # non-relevant rows before each row, counted in float64 to stay exact past 2^24 rows
        ex_cum = torch.cumsum(nonrel.to(torch.float64), 0) - nonrel
        strictly_above = (_segment_min(ex_cum, run_id, n)[run_id] - _segment_min(ex_cum, g, n)[g]).to(torch.float32)
        n_rel = gq.seg_sum(rel)
        n_nonrel = gq.seg_sum(nonrel)
        credit = n_nonrel[g] - strictly_above - 0.5 * nonrel_in_run[run_id]
        u = gq.seg_sum(torch.where(rel > 0, credit, 0.0))
        return _safe_divide(u, n_rel * n_nonrel)


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Precision and recall at k = 1..max_k, averaged over the queries."""

    def __init__(self, max_k: Optional[int] = None, adaptive_k: bool = False,
                 empty_target_action: str = "neg", ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, "mean", **kwargs)
        if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        self.max_k = max_k
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:  # pragma: no cover - compute is its own
        raise NotImplementedError

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """(precision@k, recall@k, k) for k = 1..max_k, each averaged over the queries."""
        indexes = dim_zero_cat(self.indexes)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        gq = shared_grouped_view(indexes, preds, target, self._state_anchors())
        max_k = self.max_k or int(gq.n_docs.max())
        ks = torch.arange(1, max_k + 1, dtype=torch.float32, device=preds.device)
        masks = gq.pos[None, :] < ks[:, None]  # (K, N)
        rel_hits = torch.zeros(max_k, gq.num_groups, device=preds.device).index_add_(
            1, gq.group_id, gq.rel[None, :] * masks)  # (K, G)
        k_eff = torch.minimum(ks[:, None], gq.n_docs[None, :]) if self.adaptive_k else ks[:, None]
        precision_kg = _safe_divide(rel_hits, k_eff)
        recall_kg = _safe_divide(rel_hits, gq.n_rel[None, :])
        valid = gq.n_docs > 0
        empty = (gq.n_rel == 0) & valid
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError("`compute` method was provided with a query with no positive target.")
        if self.empty_target_action == "pos":
            precision_kg = torch.where(empty[None, :], 1.0, precision_kg)
            recall_kg = torch.where(empty[None, :], 1.0, recall_kg)
        elif self.empty_target_action == "neg":
            precision_kg = torch.where(empty[None, :], 0.0, precision_kg)
            recall_kg = torch.where(empty[None, :], 0.0, recall_kg)
        else:
            valid = valid & ~empty
        denom = valid.sum().clamp(min=1)
        precision_k = (precision_kg * valid[None, :]).sum(dim=1) / denom
        recall_k = (recall_kg * valid[None, :]).sum(dim=1) / denom
        return precision_k, recall_k, torch.arange(1, max_k + 1, dtype=torch.int32, device=preds.device)

    def plot(self, curve: Optional[Tuple[Tensor, Tensor, Tensor]] = None, ax: Any = None):
        """Draw the retrieval precision-recall curve, recall along x and precision along y; needs matplotlib."""
        from metrics_tpu_torch.utils.plot import plot_curve

        computed = curve if curve is not None else self.compute()
        curve_xy = (computed[1], computed[0]) + tuple(computed[2:])
        return plot_curve(curve_xy, ax=ax, label_names=("Recall", "Precision"), name=self.__class__.__name__)


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The highest recall@k whose precision@k is at least ``min_precision``, with its k."""

    def __init__(self, min_precision: float = 0.0, max_k: Optional[int] = None, adaptive_k: bool = False,
                 empty_target_action: str = "neg", ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(max_k, adaptive_k, empty_target_action, ignore_index, **kwargs)
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a float value between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[Tensor, Tensor]:
        """(best recall, its k); (0, max_k) when no k reaches ``min_precision``."""
        precision, recall, ks = super().compute()
        p, r, k = precision.cpu().numpy(), recall.cpu().numpy(), ks.cpu().numpy()
        ok = p >= self.min_precision
        if not ok.any():
            return torch.tensor(0.0, device=self.device), torch.tensor(int(k[-1]), dtype=torch.int32, device=self.device)
        best = int(np.argmax(np.where(ok, r, -1.0)))
        return (torch.tensor(r[best], dtype=torch.float32, device=self.device),
                torch.tensor(int(k[best]), dtype=torch.int32, device=self.device))

    def plot(self, val: Any = None, ax: Any = None):
        """The generic value plot of the best recall."""
        val = val if val is not None else self.compute()[0]
        return Metric.plot(self, val, ax)
