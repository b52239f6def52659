"""Retrieval metric base: one grouping sort, then segment reductions (counterpart of
``metrics_tpu/retrieval/base.py``).

A retrieval metric keeps every ``(query id, score, target)`` row in list
states. ``compute`` sorts the rows once, by query and then by descending
score, and every metric is a few segment sums over the flat sorted arrays; no
Python loop runs over the queries.

The sort is one stable ``torch.sort`` of a 64-bit key, the key that the JAX
package builds on the CPU: the query id's low 32 bits, read as unsigned, in
the high half, and the descending-sortable IEEE bits of the float32 score in
the low half, with -0.0 taken as +0.0 and NaN ranked last. The JAX package's
key is unsigned, so a negative query id ranks after every non-negative one;
the signed key here flips the id's top bit to keep that order. Segment sums
are ``index_add_``, segment minima ``scatter_reduce``.
"""

from __future__ import annotations

import weakref
from abc import abstractmethod
from typing import Any, Dict, Optional

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor

__all__ = ["GroupedQueries", "RetrievalMetric", "shared_grouped_view"]

_LOW32 = 0xFFFFFFFF


def _retrieval_aggregate(values: Tensor, aggregation: Any, mask: Tensor) -> Tensor:
    """Aggregate the per-query scores where ``mask`` holds; 0 when no query is valid.

    ``median`` is the lower of the two middle values for an even count, as
    ``torch.median`` gives; a callable gets the valid scores.
    """
    count = mask.sum()
    zero = values.new_zeros(())
    if aggregation == "mean":
        return torch.where(count > 0, torch.where(mask, values, 0.0).sum() / count.clamp(min=1), zero)
    if aggregation == "median":
        filled = torch.sort(torch.where(mask, values, torch.inf)).values
        return torch.where(count > 0, filled[(count - 1).clamp(min=0) // 2], zero)
    if aggregation == "min":
        return torch.where(count > 0, torch.where(mask, values, torch.inf).amin(), zero)
    if aggregation == "max":
        return torch.where(count > 0, torch.where(mask, values, -torch.inf).amax(), zero)
    return aggregation(values[mask])


def _sort_key(indexes: Tensor, values: Tensor) -> Tensor:
    """The int64 key whose ascending order is (query ascending, value descending), NaN last in a query."""
    v = values.to(torch.float32) + 0.0  # -0.0 + 0.0 is +0.0
    bits = v.view(torch.int32).to(torch.int64) & _LOW32
    asc = torch.where(bits >> 31 == 0, bits | 0x80000000, ~bits & _LOW32)
    asc = torch.where(torch.isnan(v), 0, asc)
    desc = ~asc & _LOW32
    # the id's low 32 bits as unsigned, shifted into the signed range so that signed order is unsigned order
    query = (indexes.to(torch.int64) & _LOW32) - (1 << 31)
    return query * (1 << 32) + desc


def _order_by_query_desc(indexes: Tensor, values: Tensor) -> Tensor:
    """Stable argsort by (query ascending, value descending): the grouping sort."""
    return torch.sort(_sort_key(indexes, values), stable=True).indices


def _segment_sum(x: Tensor, segments: Tensor, num_segments: int) -> Tensor:
    return torch.zeros(num_segments, dtype=x.dtype, device=x.device).index_add_(0, segments, x)


def _segment_min(x: Tensor, segments: Tensor, num_segments: int) -> Tensor:
    out = torch.full((num_segments,), torch.inf, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, segments, x, "amin")


class GroupedQueries:
    """The rows sorted by (query, descending score), with what every metric needs per row and per query.

    Per row: ``group_id`` (0-based, in sorted order), ``preds``, ``graded``
    (the target as float32), ``rel`` (target > 0), ``pos`` (0-based rank in its
    query) and ``rel_cum`` (relevant rows up to and including this one in its
    query). Per query: ``n_docs`` and ``n_rel``. ``ideal_graded``, the targets
    in descending order within each query, costs a second sort and is built on
    first use (NDCG). Counts are float32, as in the JAX package.
    """

    def __init__(self, indexes: Tensor, preds: Tensor, target: Tensor):
        n = preds.shape[0]
        self.order = _order_by_query_desc(indexes, preds)
        idx_sorted = indexes[self.order]
        new_group = torch.ones(n, dtype=torch.bool, device=preds.device)
        new_group[1:] = idx_sorted[1:] != idx_sorted[:-1]
        self.group_id = torch.cumsum(new_group, 0) - 1
        self.num_groups = int(self.group_id[-1]) + 1 if n else 0  # one host read
        self.graded = target[self.order].to(torch.float32)
        self.preds = preds[self.order]
        rel = (self.graded > 0).to(torch.int64)
        self.rel = rel.to(torch.float32)
        # counts in int64, exact at any size, then float32 as the JAX package keeps them
        n_docs = torch.bincount(self.group_id, minlength=self.num_groups)
        n_rel = self.seg_sum(rel)
        starts = torch.cumsum(n_docs, 0) - n_docs
        rel_before = torch.cumsum(n_rel, 0) - n_rel
        self.pos = (torch.arange(n, device=preds.device) - starts[self.group_id]).to(torch.float32)
        self.rel_cum = (torch.cumsum(rel, 0) - rel_before[self.group_id]).to(torch.float32)
        self.n_docs = n_docs.to(torch.float32)
        self.n_rel = n_rel.to(torch.float32)
        self._ideal_inputs = (indexes, target)
        self._ideal_graded: Optional[Tensor] = None

    @property
    def ideal_graded(self) -> Tensor:
        """The targets in ideal (descending target within each query) order, sorted on first use."""
        if self._ideal_graded is None:
            indexes, target = self._ideal_inputs
            self._ideal_graded = target[_order_by_query_desc(indexes, target.to(torch.float32))].to(torch.float32)
        return self._ideal_graded

    def seg_sum(self, x: Tensor) -> Tensor:
        return _segment_sum(x, self.group_id, self.num_groups)

    def seg_min(self, x: Tensor) -> Tensor:
        return _segment_min(x, self.group_id, self.num_groups)


# Sorted views shared by the metrics of one compute group: their list states are the same tensors, so the
# second metric's compute reuses the first one's sort. Keyed by the identity of those tensors, held by weak
# reference, so that an entry dies with the states it was built from; at most four views are kept.
_VIEW_CACHE: Dict[Any, Any] = {}


def shared_grouped_view(indexes: Tensor, preds: Tensor, target: Tensor, anchors: Any) -> GroupedQueries:
    """The :class:`GroupedQueries` of these rows, built once for each tuple of state tensors ``anchors``."""
    for k in [k for k, (refs, _) in _VIEW_CACHE.items() if any(r() is None for r in refs)]:
        _VIEW_CACHE.pop(k)
    key = tuple(map(id, anchors))
    hit = _VIEW_CACHE.get(key)
    if hit is not None:
        live = [r() for r in hit[0]]
        if len(live) == len(anchors) and all(a is b for a, b in zip(live, anchors)):
            _VIEW_CACHE[key] = _VIEW_CACHE.pop(key)
            return hit[1]
    gq = GroupedQueries(indexes, preds, target)
    _VIEW_CACHE[key] = (tuple(weakref.ref(a) for a in anchors), gq)
    while len(_VIEW_CACHE) > 4:
        _VIEW_CACHE.pop(next(iter(_VIEW_CACHE)))
    return gq


class RetrievalMetric(Metric):
    """Base class of the retrieval metrics: list states ``indexes``, ``preds`` and ``target``.

    Subclasses write :meth:`_metric_vectorized`, one score per query from the
    :class:`GroupedQueries` view. ``empty_target_action`` decides the score of
    a query with no relevant document: ``"neg"`` 0, ``"pos"`` 1, ``"skip"``
    leaves it out, ``"error"`` raises in ``compute``.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        aggregation: Any = "mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.allow_non_binary_target = False
        if empty_target_action not in ("error", "skip", "neg", "pos"):
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index
        if not (aggregation in ("mean", "median", "min", "max") or callable(aggregation)):
            raise ValueError(
                "Argument `aggregation` must be one of `mean`, `median`, `min`, `max` or a custom callable function"
                f"which takes tensor of values, but got {aggregation}."
            )
        self.aggregation = aggregation
        self.add_state("indexes", [], dist_reduce_fx=None)
        self.add_state("preds", [], dist_reduce_fx=None)
        self.add_state("target", [], dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor, indexes: Tensor) -> None:
        """Check and flatten the batch, drop the ``ignore_index`` rows, and keep the rest on the metric's device."""
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            torch.as_tensor(indexes, device=self.device),
            torch.as_tensor(preds, device=self.device),
            torch.as_tensor(target, device=self.device),
            allow_non_binary_target=self.allow_non_binary_target,
            ignore_index=self.ignore_index,
        )
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    _empty_error_msg = "`compute` method was provided with a query with no positive target."

    def _state_anchors(self) -> tuple:
        return tuple(self.indexes) + tuple(self.preds) + tuple(self.target)

    def _empty_mask(self, gq: GroupedQueries) -> Tensor:
        """Which queries count as empty for ``empty_target_action``: no relevant document."""
        return gq.n_rel == 0

    def compute(self) -> Tensor:
        """Group by query with one sort and score every query by segment reductions."""
        indexes = dim_zero_cat(self.indexes)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        if preds.shape[0] == 0:
            return torch.zeros((), device=preds.device)
        gq = shared_grouped_view(indexes, preds, target, self._state_anchors())
        if self.empty_target_action == "error" and bool(self._empty_mask(gq).any()):
            raise ValueError(self._empty_error_msg)
        return self._score_groups(gq)

    def compute_flat(self, preds: Tensor, target: Tensor, indexes: Tensor) -> Tensor:
        """Score flat ``(preds, target, indexes)`` arrays without the states: group, score, aggregate.

        The rows are taken as they are, with no validation and no
        ``ignore_index``. ``empty_target_action="error"`` scores an empty query
        as ``"neg"`` does, as the JAX package's traced form has to.
        """
        if preds.shape[0] == 0:
            return torch.zeros((), device=preds.device)
        return self._score_groups(GroupedQueries(indexes, preds, target))

    def _score_groups(self, gq: GroupedQueries) -> Tensor:
        scores = self._metric_vectorized(gq)
        valid = gq.n_docs > 0
        empty = self._empty_mask(gq) & valid
        if self.empty_target_action == "pos":
            scores = torch.where(empty, 1.0, scores)
        elif self.empty_target_action in ("neg", "error"):
            scores = torch.where(empty, 0.0, scores)
        else:
            valid = valid & ~empty
        return _retrieval_aggregate(scores, self.aggregation, valid)

    @abstractmethod
    def _metric_vectorized(self, gq: GroupedQueries) -> Tensor:
        """One score per query."""
