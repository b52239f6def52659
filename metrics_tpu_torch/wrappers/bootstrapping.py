"""Bootstrap resampling of a metric (counterpart of ``metrics_tpu/wrappers/bootstrapping.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.wrappers.replicated import ReplicatedWrapper, replica_compute

__all__ = ["BootStrapper"]


def _bootstrap_sampler(size: int, sampling_strategy: str = "poisson", rng: Optional[np.random.RandomState] = None):
    """The row indices of one bootstrap replicate, drawn on the host from numpy's global random state
    (or ``rng``), as the JAX package draws them, so that one seed gives both packages the same rows."""
    rng = rng or np.random
    if sampling_strategy == "poisson":
        p = rng.poisson(1, size)
        return np.repeat(np.arange(size), p)
    if sampling_strategy == "multinomial":
        return rng.randint(0, size, size)
    raise ValueError("Unknown sampling strategy")


def _take(x: Any, idx: torch.Tensor) -> Any:
    if isinstance(x, torch.Tensor):
        return x.index_select(0, idx.to(x.device))
    return x[idx.cpu().numpy()] if hasattr(x, "shape") else x


class BootStrapper(ReplicatedWrapper):
    """``num_bootstraps`` copies of a metric, each updated on a resample of every batch; ``compute`` gives the
    mean, standard deviation (ddof 1), quantiles and raw values of the copies' scores.

    The default resampling is ``"multinomial"`` (``size`` rows drawn with replacement), as in the JAX
    package; ``"poisson"`` repeats each row a Poisson(1) number of times. The indices are drawn on the host
    and moved to the card in one copy. With multinomial resampling and a base metric that can run batched
    (``Metric._jit_eligible``), the copies are updated on the replica engine: one vmapped update of every
    copy, each taking its own index row (``wrappers/replicated.py``); otherwise each copy takes its rows
    with ``index_select`` in a loop. The wrapper lives on its metric's device unless ``device`` says
    otherwise.

    >>> from metrics_tpu_torch.classification import MulticlassAccuracy
    >>> _ = np.random.seed(123)
    >>> base = MulticlassAccuracy(num_classes=3, average='micro', device="cpu")
    >>> bootstrap = BootStrapper(base, num_bootstraps=20)
    >>> bootstrap.update(torch.from_numpy(np.random.randint(3, size=100)), torch.from_numpy(np.random.randint(3, size=100)))
    >>> sorted(bootstrap.compute())
    ['mean', 'std']
    """

    full_state_update = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float]]] = None,
        raw: bool = False,
        sampling_strategy: str = "multinomial",
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu_torch.Metric but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._init_replicas(base_metric, num_bootstraps)
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling} but received"
                f" {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each copy on its own resample of the batch."""
        arrays = [a for a in args if hasattr(a, "shape")] + [v for v in kwargs.values() if hasattr(v, "shape")]
        if not arrays:
            raise ValueError("None of the input contained tensors, so no bootstrapping was possible")
        size = arrays[0].shape[0]
        # every copy's draw first, in copy order: the JAX package's order of draws from the global state
        draws = [_bootstrap_sampler(size, self.sampling_strategy) for _ in self._replicas]
        if self.sampling_strategy == "multinomial":
            rows = torch.from_numpy(np.stack(draws)).to(self.device)  # one copy to the card
            if self._engine_ok(args, kwargs) and self._engine_update(args, kwargs, gather_idx=rows):
                return
            draws = list(rows)
        self._materialize()
        for metric, sample_idx in zip(self._replicas, draws):
            if len(sample_idx) == 0:
                continue
            idx = torch.as_tensor(sample_idx)
            metric.update(*[_take(a, idx) for a in args], **{k: _take(v, idx) for k, v in kwargs.items()})

    def compute(self) -> Dict[str, torch.Tensor]:
        """The mean, std, quantiles and raw values of the copies' scores, as the options ask."""
        computed_vals = None
        if self.__dict__.get("_stacked") is not None:
            vals = replica_compute(self._replicas[0], self.num_bootstraps, self.__dict__["_stacked"])
            if isinstance(vals, torch.Tensor):
                computed_vals = vals
            else:
                # a tuple or dict compute: the loop below stacks each copy's value
                self._materialize()
        if computed_vals is None:
            computed_vals = torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = computed_vals.mean(dim=0)
        if self.std:
            output_dict["std"] = computed_vals.std(dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=computed_vals.dtype, device=computed_vals.device)
            output_dict["quantile"] = torch.quantile(computed_vals, q, dim=0)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, torch.Tensor]:
        """Update, then the aggregate over the copies."""
        self.update(*args, **kwargs)
        return self.compute()

