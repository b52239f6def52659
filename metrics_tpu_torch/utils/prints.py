"""Single-rank emission helpers (counterpart of ``metrics_tpu/utils/prints.py``).

The rank is ``torch.distributed.get_rank()`` when a process group is up, else 0.
"""

from __future__ import annotations

import logging
import warnings
from functools import wraps
from typing import Any, Callable

import torch

log = logging.getLogger("metrics_tpu_torch")


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on rank 0 of a multi-process run."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, category: type = UserWarning, stacklevel: int = 3, **kwargs: Any) -> None:
    warnings.warn(message, category=category, stacklevel=stacklevel, **kwargs)


@rank_zero_only
def rank_zero_info(message: str, **kwargs: Any) -> None:
    log.info(message, **kwargs)


@rank_zero_only
def rank_zero_debug(message: str, **kwargs: Any) -> None:
    log.debug(message, **kwargs)
