"""Shared machinery for the "best X at a fixed Y" curve metrics.

One implementation behind ``sensitivity_at_specificity``,
``specificity_at_sensitivity``, ``precision_at_fixed_recall`` and
``recall_at_fixed_precision`` (counterpart of
``metrics_tpu/functional/classification/_fixed_point.py``). The constrained
arg-max runs on the host in float64, as in the JAX package, so its ties break
the same way; the results are float32 tensors on the curve's device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _host(x: Tensor) -> np.ndarray:
    return x.detach().cpu().double().numpy()


def _result(value: float, threshold: float, device: torch.device) -> Tuple[Tensor, Tensor]:
    return (torch.tensor(value, dtype=torch.float32, device=device),
            torch.tensor(threshold, dtype=torch.float32, device=device))


def _lex_best(primary: Tensor, secondary: Tensor, thresholds: Tensor, min_secondary: float) -> Tuple[Tensor, Tensor]:
    """Maximize ``primary`` subject to ``secondary >= min_secondary``.

    Ties break lexicographically by (primary, secondary, threshold); the
    result is (0.0, 1e6) when no point meets the constraint, and the threshold
    is 1e6 when the best primary is 0.
    """
    device = primary.device
    p, s, t = _host(primary), _host(secondary), _host(thresholds)
    n = min(p.shape[0], s.shape[0], t.shape[0])
    p, s, t = p[:n], s[:n], t[:n]
    ok = s >= min_secondary
    if not ok.any():
        return _result(0.0, 1e6, device)
    p, s, t = p[ok], s[ok], t[ok]
    idx = np.lexsort((t, s, p))[-1]  # the last key is the primary one
    best_p, best_t = p[idx], t[idx]
    if best_p == 0.0:
        best_t = 1e6
    return _result(best_p, best_t, device)


def _constrained_argmax(values: Tensor, constraint: Tensor, thresholds: Tensor,
                        min_constraint: float) -> Tuple[Tensor, Tensor]:
    """Maximize ``values`` where ``constraint >= min_constraint``: the first maximum, or (0.0, 1e6) when no
    point meets the constraint."""
    device = values.device
    v, c, t = _host(values), _host(constraint), _host(thresholds)
    n = min(v.shape[0], c.shape[0], t.shape[0])
    v, c, t = v[:n], c[:n], t[:n]
    ok = c >= min_constraint
    if not ok.any():
        return _result(0.0, 1e6, device)
    v, t = v[ok], t[ok]
    idx = int(np.argmax(v))
    return _result(v[idx], t[idx], device)


def _per_class_reduce(curves: Tuple, num_classes: int, reduce_one: Callable) -> Tuple[Tensor, Tensor]:
    """Apply a binary fixed-point reduction to each class's curve and stack the results.

    ``curves`` is (a, b, thresholds), each per class; on the binned path the
    thresholds are one grid shared by every class.
    """
    a_curves, b_curves, t_curves = curves
    vals, thrs = [], []
    for i in range(num_classes):
        t = t_curves[i] if isinstance(t_curves, list) else t_curves
        v, th = reduce_one(a_curves[i], b_curves[i], t)
        vals.append(v)
        thrs.append(th)
    return torch.stack(vals), torch.stack(thrs)
