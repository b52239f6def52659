"""FeatureShare wrapper (counterpart of ``metrics_tpu/wrappers/feature_share.py``).

Wraps metrics that each own a feature-extractor callable (FID, KID, IS sharing
one InceptionV3) so that the backbone's forward runs ONCE a batch: the shared
network is memoized on the input's identity for the duration of an update.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric

__all__ = ["FeatureShare", "NetworkCache"]


class NetworkCache:
    """Memoize a feature network on argument identity.

    Each entry holds a strong reference to its argument: an ``id()`` is reused once its object is freed, so a
    hit counts only when the cached argument is the very same live object.
    """

    def __init__(self, network: Callable, max_size: int = 100) -> None:
        self.network = network
        self.max_size = max_size
        self._cache: Dict[int, Any] = {}
        self._order: List[int] = []

    def __call__(self, x: Any) -> Any:
        key = id(x)
        hit = self._cache.get(key)
        if hit is not None and hit[0] is x:
            return hit[1]
        out = self.network(x)
        self._cache[key] = (x, out)
        self._order.append(key)
        if len(self._order) > self.max_size:
            self._cache.pop(self._order.pop(0), None)
        return out


class FeatureShare(MetricCollection):
    """Share one feature-network forward across member metrics.

    Each member exposes its feature callable as ``feature_extractor`` (or ``net``); it is replaced by one
    :class:`NetworkCache` around the first member's network, or around ``network`` when given.
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        max_cache_size: Optional[int] = None,
        network: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(metrics, **kwargs)
        if max_cache_size is None:
            max_cache_size = len(self)
        if not isinstance(max_cache_size, int):
            raise TypeError(f"max_cache_size should be an integer, but got {max_cache_size}")

        attr_names = ("feature_extractor", "net")
        shared_net = network
        if shared_net is None:
            shared_net = next(
                (fn for m in self.values() for fn in (getattr(m, a, None) for a in attr_names) if callable(fn)), None
            )
        if shared_net is None:
            raise AttributeError(
                "Tried to extract the network to share from the first metric, but it did not have a"
                " `feature_extractor` or `net` attribute. Please provide the `network` argument."
            )
        cache = NetworkCache(shared_net, max_size=max_cache_size)
        for m in self.values():
            for attr in attr_names:
                if callable(getattr(m, attr, None)):
                    setattr(m, attr, cache)
        self.network_cache = cache
