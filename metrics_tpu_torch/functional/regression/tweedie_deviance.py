"""Tweedie deviance (counterpart of ``metrics_tpu/functional/regression/tweedie_deviance.py``).

The power selects the formula on the host; the data path has no branch. As in
the JAX package, a power in (0, 1) raises and no value domain is checked.
"""

from __future__ import annotations

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import _safe_xlogy

Tensor = torch.Tensor


def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, Tensor]:
    """The summed deviance in float32 and the number of elements."""
    _check_same_shape(preds, targets)
    preds, targets = preds.to(torch.float32), targets.to(torch.float32)
    if power < 0:
        deviance_score = 2 * (
            torch.pow(torch.clamp(targets, min=0), 2 - power) / ((1 - power) * (2 - power))
            - targets * torch.pow(preds, 1 - power) / (1 - power)
            + torch.pow(preds, 2 - power) / (2 - power)
        )
    elif power == 0:
        deviance_score = torch.pow(targets - preds, 2)
    elif power == 1:
        deviance_score = 2 * (_safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:
        deviance_score = 2 * (torch.log(preds / targets) + targets / preds - 1)
    elif power > 1:
        deviance_score = 2 * (
            torch.pow(targets, 2 - power) / ((1 - power) * (2 - power))
            - targets * torch.pow(preds, 1 - power) / (1 - power)
            + torch.pow(preds, 2 - power) / (2 - power)
        )
    else:
        raise ValueError(
            f"Deviance Score is not defined for power={power}. Set power to be in (-inf, 0] u [1, inf)."
        )
    return torch.sum(deviance_score), torch.tensor(deviance_score.numel(), device=deviance_score.device)


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    """The mean deviance."""
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tensor:
    """Tweedie deviance score of the given power.

    >>> tweedie_deviance_score(torch.tensor([4.0, 3.0, 2.0, 1.0]), torch.tensor([1.0, 2.0, 3.0, 4.0]), power=2)
    tensor(1.2083)
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
