"""Nominal-association metrics (counterpart of ``metrics_tpu/functional/nominal/metrics.py``).

Each statistic is a function of one contingency matrix (``_*_from_confmat``). The NaN handling runs on the
inputs' device in float64, as the JAX package's does on the host. The ``*_matrix`` functions count the tables
of every column pair in one ``bincount`` (:func:`_pair_contingencies`) and then apply the same per-table
statistic as the scalar functions, so each entry is the value the scalar function gives for its pair.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.clustering.extrinsic import calculate_contingency_matrix
from metrics_tpu_torch.utils.compute import acc_dtype
from metrics_tpu_torch.utils.data import compact_labels
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _handle_nan(
    preds: torch.Tensor, target: torch.Tensor, nan_strategy: str, nan_replace_value: Optional[float]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both variables flattened in float64, with the rows where either is NaN dropped (``"drop"``) or every NaN
    replaced by ``nan_replace_value``."""
    p = preds.reshape(-1).to(torch.float64)
    t = target.reshape(-1).to(torch.float64)
    if nan_strategy == "drop":
        keep = ~(torch.isnan(p) | torch.isnan(t))
        return p[keep], t[keep]
    return torch.nan_to_num(p, nan=nan_replace_value), torch.nan_to_num(t, nan=nan_replace_value)


def _chi2_phi2(confmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    n = confmat.sum()
    expected = confmat.sum(dim=1, keepdim=True) * confmat.sum(dim=0, keepdim=True) / n
    nz = expected > 0
    chi2 = torch.sum(torch.where(nz, (confmat - expected) ** 2 / torch.where(nz, expected, 1.0), 0.0))
    return chi2, chi2 / n, confmat.shape[0], confmat.shape[1]


def _default_float(value: float, like: torch.Tensor) -> torch.Tensor:
    """A host number as a 0-d tensor of the default float type on ``like``'s device, as ``jnp.asarray`` makes
    one of the JAX package's default float type."""
    return torch.tensor(value, dtype=torch.get_default_dtype(), device=like.device)


def _cramers_v_from_confmat(confmat: torch.Tensor, bias_correction: bool) -> torch.Tensor:
    _, phi2, r, k = _chi2_phi2(confmat)
    n = confmat.sum()
    if bias_correction:
        phi2 = torch.clamp(phi2 - (r - 1) * (k - 1) / (n - 1), min=0.0)
        n_minus_1 = float(n - 1)
        r = r - (r - 1) ** 2 / n_minus_1
        k = k - (k - 1) ** 2 / n_minus_1
        denom = torch.minimum(_default_float(r - 1, confmat), _default_float(k - 1, confmat))
        if float(denom) == 0:
            rank_zero_warn(
                "Unable to compute Cramer's V using bias correction. Please consider to set `bias_correction=False`."
            )
            return _default_float(float("nan"), confmat)
    else:
        denom = min(r - 1, k - 1)
    return torch.sqrt(phi2 / denom)


def _tschuprows_t_from_confmat(confmat: torch.Tensor, bias_correction: bool) -> torch.Tensor:
    _, phi2, r, k = _chi2_phi2(confmat)
    n = confmat.sum()
    if bias_correction:
        phi2 = torch.clamp(phi2 - (r - 1) * (k - 1) / (n - 1), min=0.0)
        n_minus_1 = float(n - 1)
        rr = r - (r - 1) ** 2 / n_minus_1
        kk = k - (k - 1) ** 2 / n_minus_1
        denom = torch.sqrt(_default_float((rr - 1) * (kk - 1), confmat))
    else:
        denom = torch.sqrt(_default_float(float((r - 1) * (k - 1)), confmat))
    return torch.sqrt(phi2 / denom)


def _pearsons_contingency_coefficient_from_confmat(confmat: torch.Tensor) -> torch.Tensor:
    chi2, _, _, _ = _chi2_phi2(confmat)
    n = confmat.sum()
    return torch.sqrt(chi2 / (chi2 + n))


def _theils_u_from_confmat(confmat: torch.Tensor) -> torch.Tensor:
    """U(preds | target) from a table whose rows are the target's values and columns the predictions'."""
    n = confmat.sum()
    p_pred = confmat.sum(dim=0) / n
    h_x = -torch.sum(torch.where(p_pred > 0, p_pred * torch.log(torch.where(p_pred > 0, p_pred, 1.0)), 0.0))
    p_t = confmat.sum(dim=1, keepdim=True) / n
    cond = confmat / n
    nz = cond > 0
    log_ratio = torch.log(torch.where(nz, cond, 1.0)) - torch.log(p_t.expand(cond.shape))
    h_xy = -torch.sum(torch.where(nz, cond * log_ratio, 0.0))
    return torch.where(h_x > 0, (h_x - h_xy) / h_x.clamp(min=1e-12), 1.0)


def _nan_handled_confmat(preds, target, nan_strategy, nan_replace_value) -> torch.Tensor:
    preds, target = _handle_nan(preds, target, nan_strategy, nan_replace_value)
    return calculate_contingency_matrix(preds, target)


def cramers_v(
    preds: torch.Tensor,
    target: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Cramer's V between two categorical variables.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = rng.randint(0, 4, (100,))
    >>> target = (preds + rng.randint(0, 2, (100,))) % 4
    >>> round(float(cramers_v(torch.from_numpy(preds), torch.from_numpy(target))), 4)
    0.577
    """
    confmat = _nan_handled_confmat(preds, target, nan_strategy, nan_replace_value)
    return _cramers_v_from_confmat(confmat, bias_correction)


def tschuprows_t(
    preds: torch.Tensor,
    target: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Tschuprow's T between two categorical variables."""
    confmat = _nan_handled_confmat(preds, target, nan_strategy, nan_replace_value)
    return _tschuprows_t_from_confmat(confmat, bias_correction)


def pearsons_contingency_coefficient(
    preds: torch.Tensor,
    target: torch.Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Pearson's contingency coefficient between two categorical variables."""
    confmat = _nan_handled_confmat(preds, target, nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_from_confmat(confmat)


def theils_u(
    preds: torch.Tensor,
    target: torch.Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Theil's U, the uncertainty coefficient U(preds | target).

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> preds = torch.from_numpy(rng.randint(0, 4, (100,)))
    >>> target = torch.from_numpy(rng.randint(0, 4, (100,)))
    >>> float(theils_u(preds, target)) < 0.2
    True
    """
    confmat = _nan_handled_confmat(preds, target, nan_strategy, nan_replace_value)
    return _theils_u_from_confmat(confmat)


def fleiss_kappa(ratings: torch.Tensor, mode: str = "counts") -> torch.Tensor:
    """Fleiss' kappa for inter-rater agreement.

    ``mode="counts"``: ``ratings`` is an (n_samples, n_categories) count matrix; ``mode="probs"``: an
    (n_samples, n_categories, n_raters) tensor of probabilities, each rater voting for its arg-max category.

    >>> round(float(fleiss_kappa(torch.tensor([[0, 0, 14], [0, 2, 12], [0, 6, 8], [0, 12, 2]]))), 4)
    0.4256
    """
    if mode == "probs":
        if ratings.ndim != 3 or not ratings.is_floating_point():
            raise ValueError("If argument ``mode`` is 'probs', ratings must have 3 dimensions with the format"
                             " [n_samples, n_categories, n_raters] and be floating point")
        votes = torch.argmax(ratings, dim=1)
        counts = torch.zeros((ratings.shape[0], ratings.shape[1]), dtype=torch.float32, device=ratings.device)
        ratings = counts.scatter_add_(1, votes, torch.ones(votes.shape, dtype=torch.float32, device=ratings.device))
    elif mode == "counts":
        if ratings.ndim != 2:
            raise ValueError("If argument ``mode`` is `counts`, ratings must have 2 dimensions with the format"
                             " [n_subjects, n_categories]")
        ratings = ratings.to(torch.float32)
    else:
        raise ValueError("Argument ``mode`` must be one of 'counts' or 'probs'")

    n_subjects = ratings.shape[0]
    n_raters = ratings[0].sum()
    p_cat = ratings.sum(dim=0) / (n_subjects * n_raters)
    p_subject = (torch.sum(ratings * ratings, dim=1) - n_raters) / (n_raters * (n_raters - 1))
    p_bar = p_subject.mean()
    pe_bar = torch.sum(p_cat**2)
    return (p_bar - pe_bar) / (1 - pe_bar)


def _pair_contingencies(
    matrix: torch.Tensor, pairs: Sequence[Tuple[int, int]], nan_strategy: str, nan_replace_value: Optional[float]
) -> List[torch.Tensor]:
    """The contingency matrix of ``(preds=column i, target=column j)`` for each pair, as the scalar functions
    build it after their NaN handling, all counted in one ``bincount``.

    Each column's values are coded once, in sorted order; the pairs' tables are counted into one
    ``(P, K, K)`` tensor (``K`` the most values of any column); a table then keeps the rows and columns of
    the values its pair's kept rows have, which one host read finds for every pair.
    """
    values = matrix.to(torch.float64)
    if nan_strategy == "drop":
        nan = torch.isnan(values)
        # a dropped row's value is never counted: a stand-in code that no kept row has is removed below
        values = torch.where(nan, 0.0, values)
    else:
        nan = None
        values = torch.nan_to_num(values, nan=nan_replace_value)
    coded = [compact_labels(values[:, col]) for col in range(values.shape[1])]
    codes = torch.stack([c for c, _ in coded], dim=1)
    width = max([k for _, k in coded] + [1])
    pi = torch.tensor([i for i, _ in pairs], dtype=torch.long, device=matrix.device)
    pj = torch.tensor([j for _, j in pairs], dtype=torch.long, device=matrix.device)
    offset = torch.arange(len(pairs), device=matrix.device) * (width * width)
    flat = offset[None, :] + codes[:, pj] * width + codes[:, pi]
    if nan is not None:
        flat = flat[~(nan[:, pi] | nan[:, pj])]
    counts = torch.bincount(flat.reshape(-1), minlength=len(pairs) * width * width).reshape(len(pairs), width, width)
    rows_present = (counts.sum(dim=2) > 0).cpu()
    cols_present = (counts.sum(dim=1) > 0).cpu()
    tables = []
    for p in range(len(pairs)):
        rows = rows_present[p].nonzero().reshape(-1).to(matrix.device)
        cols = cols_present[p].nonzero().reshape(-1).to(matrix.device)
        tables.append(counts[p][rows][:, cols].to(acc_dtype()))
    return tables


def _matrix_over_pairs(
    matrix: torch.Tensor,
    statistic: Callable[[torch.Tensor], torch.Tensor],
    nan_strategy: str,
    nan_replace_value: Optional[float],
    symmetric: bool,
) -> torch.Tensor:
    """The float32 ``(V, V)`` matrix of ``statistic`` over the column pairs, 1 on the diagonal: each pair
    ``i < j`` on both sides (``symmetric``), or every ordered pair ``i != j``."""
    num_var = matrix.shape[1]
    pairs = [(i, j) for i in range(num_var) for j in range(num_var) if (i < j if symmetric else i != j)]
    out = torch.ones((num_var, num_var), dtype=torch.float32, device=matrix.device)
    if not pairs:
        return out
    tables = _pair_contingencies(matrix, pairs, nan_strategy, nan_replace_value)
    vals = torch.stack([statistic(t).to(torch.float32) for t in tables])
    pi = torch.tensor([i for i, _ in pairs], device=matrix.device)
    pj = torch.tensor([j for _, j in pairs], device=matrix.device)
    out[pi, pj] = vals
    if symmetric:
        out[pj, pi] = vals
    return out


def cramers_v_matrix(
    matrix: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Cramer's V between all column pairs of an (N, V) matrix."""
    return _matrix_over_pairs(matrix, lambda c: _cramers_v_from_confmat(c, bias_correction), nan_strategy,
                              nan_replace_value, symmetric=True)


def tschuprows_t_matrix(
    matrix: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> torch.Tensor:
    """Tschuprow's T between all column pairs of an (N, V) matrix."""
    return _matrix_over_pairs(matrix, lambda c: _tschuprows_t_from_confmat(c, bias_correction), nan_strategy,
                              nan_replace_value, symmetric=True)


def pearsons_contingency_coefficient_matrix(
    matrix: torch.Tensor, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> torch.Tensor:
    """Pearson's contingency coefficient between all column pairs of an (N, V) matrix."""
    return _matrix_over_pairs(matrix, _pearsons_contingency_coefficient_from_confmat, nan_strategy,
                              nan_replace_value, symmetric=True)


def theils_u_matrix(
    matrix: torch.Tensor, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> torch.Tensor:
    """Theil's U between all ordered column pairs of an (N, V) matrix: entry (i, j) is U(column i | column j)."""
    return _matrix_over_pairs(matrix, _theils_u_from_confmat, nan_strategy, nan_replace_value, symmetric=False)
