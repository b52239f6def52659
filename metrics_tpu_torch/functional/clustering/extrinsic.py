"""Label-comparison clustering metrics from the contingency matrix (counterpart of
``metrics_tpu/functional/clustering/extrinsic.py``).

The labels are compacted on their own device (:func:`~metrics_tpu_torch.utils.data.compact_labels`) and the
contingency matrix is one ``bincount`` of paired codes, counted in int64 and cast to ``acc_dtype()``: float32,
or float64 under a float64 default, as the JAX package's is float64 under x64. The counts equal the JAX
package's below 2^24 per cell. Everything else is closed-form arithmetic on the matrix in its type.

The expected mutual information of AMI, which the JAX package sums in a host loop over every cell and every
``n_ij``, is a blocked float64 sum on the device (:func:`_expected_mutual_info`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import acc_dtype, log_factorial_table
from metrics_tpu_torch.utils.data import compact_labels

# the terms of one EMI block: their n_ij and eight more float64 or int64 temporaries of the same size
_EMI_BYTES_PER_TERM = 80
_CPU_EMI_BLOCK_TERMS = 1 << 22


def calculate_contingency_matrix(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Contingency matrix between two clusterings: rows are the target's labels, columns the predictions',
    each in sorted order.

    >>> calculate_contingency_matrix(torch.tensor([2, 1, 0, 1, 0]), torch.tensor([0, 2, 1, 1, 0]))
    tensor([[1., 0., 1.],
            [1., 1., 0.],
            [0., 1., 0.]])
    """
    _check_same_shape(preds, target)
    pc, n_preds = compact_labels(preds)
    tc, n_target = compact_labels(target)
    counts = torch.bincount(tc * n_preds + pc, minlength=n_target * n_preds)
    return counts.reshape(n_target, n_preds).to(acc_dtype())


def _entropy(counts: torch.Tensor) -> torch.Tensor:
    n = counts.sum()
    p = counts / n
    return -torch.sum(torch.where(p > 0, p * torch.log(torch.where(p > 0, p, 1.0)), 0.0))


def _mutual_info_from_contingency(c: torch.Tensor) -> torch.Tensor:
    n = c.sum()
    pi = c.sum(dim=1)
    pj = c.sum(dim=0)
    outer = pi[:, None] * pj[None, :]
    nz = c > 0
    log_n = torch.log(n)
    terms = (c / n) * (torch.log(torch.where(nz, c, 1.0)) - log_n - torch.log(torch.where(nz, outer, 1.0))
                       + 2 * log_n)
    return torch.sum(torch.where(nz, terms, 0.0))


def mutual_info_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mutual information between two clusterings.

    >>> mutual_info_score(torch.tensor([2, 1, 0, 1, 0]), torch.tensor([0, 2, 1, 1, 0]))
    tensor(0.5004)
    """
    return _mutual_info_from_contingency(calculate_contingency_matrix(preds, target))


def rand_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Rand score: the share of sample pairs on which the clusterings agree.

    >>> rand_score(torch.tensor([2, 1, 0, 1, 0]), torch.tensor([0, 2, 1, 1, 0]))
    tensor(0.6000)
    """
    c = calculate_contingency_matrix(preds, target)
    n = c.sum()
    sum_sq = torch.sum(c**2)
    sum_rows_sq = torch.sum(c.sum(dim=1) ** 2)
    sum_cols_sq = torch.sum(c.sum(dim=0) ** 2)
    agree = (n * n - n - sum_rows_sq - sum_cols_sq + 2 * sum_sq) / 2
    total = n * (n - 1) / 2
    return agree / total


def _comb2(x: torch.Tensor) -> torch.Tensor:
    return x * (x - 1) / 2.0


def adjusted_rand_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Adjusted Rand score.

    >>> adjusted_rand_score(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]))
    tensor(1.)
    """
    c = calculate_contingency_matrix(preds, target)
    n = c.sum()
    sum_comb = torch.sum(_comb2(c))
    sum_a = torch.sum(_comb2(c.sum(dim=1)))
    sum_b = torch.sum(_comb2(c.sum(dim=0)))
    expected = sum_a * sum_b / _comb2(n)
    max_index = (sum_a + sum_b) / 2.0
    denom = max_index - expected
    return torch.where(denom != 0, (sum_comb - expected) / torch.where(denom != 0, denom, 1.0), 1.0)


def fowlkes_mallows_index(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Fowlkes-Mallows index."""
    c = calculate_contingency_matrix(preds, target)
    n = c.sum()
    tk = torch.sum(c**2) - n
    pk = torch.sum(c.sum(dim=0) ** 2) - n
    qk = torch.sum(c.sum(dim=1) ** 2) - n
    value = torch.sqrt(tk / pk.clamp(min=1)) * torch.sqrt(tk / qk.clamp(min=1))
    return torch.where((pk > 0) & (qk > 0), value, 0.0)


def _homogeneity_completeness(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    c = calculate_contingency_matrix(preds, target)
    mi = _mutual_info_from_contingency(c)
    h_target = _entropy(c.sum(dim=1))
    h_preds = _entropy(c.sum(dim=0))
    homogeneity = torch.where(h_target > 0, mi / h_target.clamp(min=1e-12), 1.0)
    completeness = torch.where(h_preds > 0, mi / h_preds.clamp(min=1e-12), 1.0)
    return homogeneity, completeness


def homogeneity_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Homogeneity: each predicted cluster holds one target class."""
    return _homogeneity_completeness(preds, target)[0]


def completeness_score(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Completeness: each target class falls into one predicted cluster."""
    return _homogeneity_completeness(preds, target)[1]


def v_measure_score(preds: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """V-measure: the weighted harmonic mean of homogeneity and completeness."""
    h, c = _homogeneity_completeness(preds, target)
    denom = beta * h + c
    return torch.where(denom > 0, (1 + beta) * h * c / denom.clamp(min=1e-12), 0.0)


def _generalized_average(u: torch.Tensor, v: torch.Tensor, method: str) -> torch.Tensor:
    if method == "min":
        return torch.minimum(u, v)
    if method == "max":
        return torch.maximum(u, v)
    if method == "arithmetic":
        return (u + v) / 2.0
    if method == "geometric":
        return torch.sqrt(u * v)
    raise ValueError(f"Expected average method to be one of (min, max, arithmetic, geometric), got {method}")


def normalized_mutual_info_score(
    preds: torch.Tensor, target: torch.Tensor, average_method: str = "arithmetic"
) -> torch.Tensor:
    """Normalized mutual information.

    >>> normalized_mutual_info_score(torch.tensor([1, 1, 0, 0]), torch.tensor([0, 0, 1, 1]))
    tensor(1.)
    """
    c = calculate_contingency_matrix(preds, target)
    mi = _mutual_info_from_contingency(c)
    h_t = _entropy(c.sum(dim=1))
    h_p = _entropy(c.sum(dim=0))
    norm = _generalized_average(h_t, h_p, average_method)
    value = mi / norm.clamp(min=1e-12)
    return torch.where((mi > 1e-12) & (norm > 0), value, torch.where(mi <= 1e-12, 0.0, 1.0))


def _emi_block_terms(device: torch.device) -> int:
    """Terms per EMI block: on a CUDA device, as many as keep a block within a quarter of the free memory; on
    the CPU, ``_CPU_EMI_BLOCK_TERMS``."""
    if device.type != "cuda":
        return _CPU_EMI_BLOCK_TERMS
    free, _ = torch.cuda.mem_get_info(device)
    return int(max(1, free // 4 // _EMI_BYTES_PER_TERM))


def _expected_mutual_info(c: torch.Tensor) -> torch.Tensor:
    """Expected mutual information under the permutation model, in float64 on ``c``'s device; returns float32.

    The sum runs over every cell ``(i, j)`` and every ``n_ij`` in ``[max(1, a_i + b_j - n), min(a_i, b_j)]``
    of the term ``n_ij / n * log(n n_ij / (a_i b_j)) * P(n_ij)``, the hypergeometric probability ``P`` from
    nine log-factorials looked up in one table. The cells are sorted by the length of their range and taken in
    blocks, each block as a ``(cells, longest range)`` tensor masked past each cell's own range, sized from the
    free memory (:func:`_emi_block_terms`).
    """
    counts = c.to(torch.float64)
    n = int(round(float(counts.sum())))
    a = counts.sum(dim=1).round().long()
    b = counts.sum(dim=0).round().long()
    ai = a[:, None].expand(len(a), len(b)).reshape(-1)
    bj = b[None, :].expand(len(a), len(b)).reshape(-1)
    lo = torch.clamp(ai + bj - n, min=1)
    span = torch.minimum(ai, bj) - lo + 1
    order = torch.argsort(span, descending=True)
    ai, bj, lo, span = ai[order], bj[order], lo[order], span[order]
    # float64 holds a_i * b_j and n * n_ij exactly: both stay below 2^53
    lf = log_factorial_table(n, c.device)
    # the part of log P that each cell shares by all its terms
    log_cell = lf[ai] + lf[bj] + lf[n - ai] + lf[n - bj] - lf[n]
    ab = ai.to(torch.float64) * bj.to(torch.float64)
    spans = span.tolist()
    budget = _emi_block_terms(c.device)
    emi = torch.zeros((), dtype=torch.float64, device=c.device)
    start = 0
    while start < len(spans):
        width = spans[start]
        stop = min(len(spans), start + max(1, budget // width))
        k = torch.arange(width, device=c.device)
        nij = lo[start:stop, None] + k[None, :]
        inside = k[None, :] < span[start:stop, None]
        nij = torch.where(inside, nij, lo[start:stop, None])
        a_blk, b_blk = ai[start:stop, None], bj[start:stop, None]
        log_p = log_cell[start:stop, None] - lf[nij] - lf[a_blk - nij] - lf[b_blk - nij] - lf[n - a_blk - b_blk + nij]
        nij_f = nij.to(torch.float64)
        term = nij_f / n * torch.log(n * nij_f / ab[start:stop, None]) * torch.exp(log_p)
        emi = emi + torch.where(inside, term, 0.0).sum()
        start = stop
    return emi.to(torch.float32)


def adjusted_mutual_info_score(
    preds: torch.Tensor, target: torch.Tensor, average_method: str = "arithmetic"
) -> torch.Tensor:
    """Adjusted mutual information.

    >>> adjusted_mutual_info_score(torch.tensor([1, 1, 0, 0]), torch.tensor([0, 0, 1, 1]))
    tensor(1.)
    """
    c = calculate_contingency_matrix(preds, target)
    mi = _mutual_info_from_contingency(c)
    emi = _expected_mutual_info(c)
    h_t = _entropy(c.sum(dim=1))
    h_p = _entropy(c.sum(dim=0))
    norm = _generalized_average(h_t, h_p, average_method)
    denom = norm - emi
    eps = torch.finfo(torch.float32).eps
    if abs(float(denom)) < eps:
        denom = torch.tensor(eps, device=denom.device)
    return (mi - emi) / denom
