"""Single-query retrieval metrics (counterpart of ``metrics_tpu/functional/retrieval/metrics.py``).

Each takes ONE query's 1-D ``preds`` and ``target`` and returns a float32
scalar. Documents are ranked by descending score with a stable sort, so equal
scores keep their input order; -0.0 ranks as +0.0 and NaN ranks last. The
many-query engine is :mod:`metrics_tpu_torch.retrieval.base`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

__all__ = [
    "retrieval_auroc",
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]


def _desc_order(preds: Tensor) -> Tensor:
    """Stable argsort by descending score; ``+ 0.0`` turns -0.0 into +0.0 so the two tie."""
    return torch.argsort(-(preds + 0.0), stable=True)


def _sort_by_preds(preds: Tensor, target: Tensor) -> Tensor:
    return target[_desc_order(preds)]


def _top_k(preds: Tensor, top_k: Optional[int]) -> int:
    k = preds.shape[-1] if top_k is None else top_k
    if not (isinstance(k, int) and k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")
    return k


def _positions(n: int, device: torch.device) -> Tensor:
    return torch.arange(n, dtype=torch.float32, device=device)


def retrieval_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None, adaptive_k: bool = False) -> Tensor:
    """Precision@k for a single query.

    >>> retrieval_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), top_k=2)
    tensor(0.5000)
    """
    k = _top_k(preds, top_k)
    if adaptive_k and k > preds.shape[-1]:
        k = preds.shape[-1]
    sorted_target = _sort_by_preds(preds, target)[:k]
    return ((sorted_target > 0).sum() / k).to(torch.float32)


def retrieval_recall(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Recall@k for a single query.

    >>> retrieval_recall(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), top_k=2)
    tensor(0.5000)
    """
    k = _top_k(preds, top_k)
    relevant = (_sort_by_preds(preds, target)[:k] > 0).sum()
    total = (target > 0).sum()
    return torch.where(total > 0, relevant / total.clamp(min=1), 0.0).to(torch.float32)


def retrieval_fall_out(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Fall-out@k for a single query: the share of the non-relevant documents ranked in the top k."""
    k = _top_k(preds, top_k)
    sorted_target = _sort_by_preds(preds, target)[:k]
    n_nonrel = (target == 0).sum()
    return torch.where(n_nonrel > 0, (sorted_target == 0).sum() / n_nonrel.clamp(min=1), 0.0).to(torch.float32)


def retrieval_hit_rate(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Hit-rate@k for a single query: 1 when a relevant document is in the top k."""
    k = _top_k(preds, top_k)
    return ((_sort_by_preds(preds, target)[:k] > 0).sum() > 0).to(torch.float32)


def retrieval_average_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Average precision for a single query.

    >>> retrieval_average_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
    tensor(0.8333)
    """
    k = _top_k(preds, top_k)
    sorted_target = (_sort_by_preds(preds, target) > 0).to(torch.float32)
    pos = _positions(sorted_target.shape[0], preds.device)
    prec_at_i = torch.cumsum(sorted_target, 0) / (pos + 1)
    within_k = pos < k
    n_rel_at_k = (sorted_target * within_k).sum()
    return torch.where(
        n_rel_at_k > 0, (prec_at_i * sorted_target * within_k).sum() / n_rel_at_k.clamp(min=1), 0.0
    ).to(torch.float32)


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Reciprocal rank of the first relevant document.

    >>> retrieval_reciprocal_rank(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([False, True, False]))
    tensor(0.5000)
    """
    k = _top_k(preds, top_k)
    sorted_target = _sort_by_preds(preds, target) > 0
    pos = _positions(sorted_target.shape[0], preds.device)
    first_rel = torch.where(sorted_target & (pos < k), pos + 1, torch.inf).amin()
    return torch.where(torch.isfinite(first_rel), 1.0 / first_rel, 0.0).to(torch.float32)


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """R-precision for a single query: precision at the number of relevant documents."""
    sorted_target = (_sort_by_preds(preds, target) > 0).to(torch.float32)
    n_rel = sorted_target.sum()
    pos = _positions(sorted_target.shape[0], preds.device)
    hits = (sorted_target * (pos < n_rel)).sum()
    return torch.where(n_rel > 0, hits / n_rel.clamp(min=1), 0.0).to(torch.float32)


def _dcg(target_sorted: Tensor, k_mask: Tensor) -> Tensor:
    discount = 1.0 / torch.log2(_positions(target_sorted.shape[0], target_sorted.device) + 2.0)
    return (target_sorted * discount * k_mask).sum()


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """NDCG@k for a single query with graded relevance.

    >>> retrieval_normalized_dcg(torch.tensor([.85, .25, .15, .35]), torch.tensor([1, 0, 0, 1]))
    tensor(1.)
    """
    k = _top_k(preds, top_k)
    target_f = target.to(torch.float32)
    sorted_by_pred = _sort_by_preds(preds, target_f)
    ideal = torch.sort(target_f, descending=True).values
    k_mask = _positions(target_f.shape[0], preds.device) < k
    dcg = _dcg(sorted_by_pred, k_mask)
    idcg = _dcg(ideal, k_mask)
    return torch.where(idcg > 0, dcg / idcg.clamp(min=1e-12), 0.0).to(torch.float32)


def retrieval_auroc(
    preds: Tensor, target: Tensor, top_k: Optional[int] = None, max_fpr: Optional[float] = None
) -> Tensor:
    """AUROC over the top-k documents of a single query; 0 when they are all relevant or none is.

    >>> retrieval_auroc(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
    tensor(0.5000)
    """
    from metrics_tpu_torch.functional.classification.auroc import binary_auroc

    k = min(_top_k(preds, top_k), preds.shape[-1])
    order = _desc_order(preds)[:k]
    top_target = target[order].to(torch.int32)
    n_pos = top_target.sum()
    degenerate = (n_pos == 0) | (n_pos == k)
    auroc_val = binary_auroc(preds[order], top_target, max_fpr=max_fpr)
    return torch.where(degenerate, 0.0, auroc_val).to(torch.float32)


def retrieval_precision_recall_curve(
    preds: Tensor, target: Tensor, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision and recall at k = 1..max_k for a single query, and the ks."""
    n = preds.shape[-1]
    if max_k is None:
        max_k = n
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")
    if adaptive_k and max_k > n:
        max_k = n
    sorted_target = (_sort_by_preds(preds, target) > 0).to(torch.float32)
    padded = torch.cat([sorted_target, sorted_target.new_zeros(max(0, max_k - n))])
    cum_rel = torch.cumsum(padded, 0)[:max_k]
    ks = torch.arange(1, max_k + 1, dtype=torch.int32, device=preds.device)
    precision = cum_rel / ks.to(torch.float32)
    total = sorted_target.sum()
    recall = torch.where(total > 0, cum_rel / total.clamp(min=1), 0.0)
    return precision, recall, ks
