"""Generative-image metrics: FID, KID, InceptionScore, MiFID (counterpart of ``metrics_tpu/image/generative.py``).

The feature extractor is injected (any function mapping an image batch to features, or updates with
precomputed features when it is None) or, for an integer ``feature``, the FID InceptionV3 resolved from local
weights (:mod:`metrics_tpu_torch.models.hub`) on the metric's device.

FID keeps streaming float32 states: each batch's feature sum and outer product are formed in float64 on the
metric's device and added to them, as the JAX package forms them in float64 on the host. Every compute runs
in float64 on the metric's device: FID's matrix square root as the symmetric ``sqrt(cov1)·cov2·sqrt(cov1)``
through two ``torch.linalg.eigh`` calls, KID's polynomial-kernel MMD over subsets drawn by
``np.random.RandomState(0)`` (the JAX package's draws), MiFID's nearest-cosine memorization distance.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype
from metrics_tpu_torch.utils.data import dim_zero_cat

__all__ = [
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "MemorizationInformedFrechetInceptionDistance",
]


def _sqrtm_trace_product(cov1: torch.Tensor, cov2: torch.Tensor) -> torch.Tensor:
    """trace(sqrtm(cov1 @ cov2)) for PSD inputs via two eigh calls (float64)."""
    vals1, vecs1 = torch.linalg.eigh(cov1)
    sqrt_cov1 = (vecs1 * vals1.clamp(min=0).sqrt()) @ vecs1.T
    inner = sqrt_cov1 @ cov2 @ sqrt_cov1
    vals = torch.linalg.eigvalsh((inner + inner.T) / 2)
    return vals.clamp(min=0).sqrt().sum()


def _fid_from_stats(
    sum1: torch.Tensor, cov_sum1: torch.Tensor, n1: int, sum2: torch.Tensor, cov_sum2: torch.Tensor, n2: int
) -> torch.Tensor:
    """FID from streaming sums, in float64."""
    mu1 = sum1 / n1
    mu2 = sum2 / n2
    cov1 = (cov_sum1 - n1 * torch.outer(mu1, mu1)) / (n1 - 1)
    cov2 = (cov_sum2 - n2 * torch.outer(mu2, mu2)) / (n2 - 1)
    diff = mu1 - mu2
    return diff @ diff + torch.trace(cov1) + torch.trace(cov2) - 2 * _sqrtm_trace_product(cov1, cov2)


def _inception(metric: Metric, feature: int) -> Callable:
    from metrics_tpu_torch.models.hub import load_feature_extractor

    return load_feature_extractor("inception_v3_fid", feature=feature, device=metric.device)


class FrechetInceptionDistance(Metric):
    """Fréchet Inception Distance.

    Args:
        feature: a function mapping an image batch to (N, D) features, None to update with feature batches,
            or an integer tap of the FID InceptionV3 resolved from local weights.
        reset_real_features: whether ``reset`` also clears the real-set statistics.
        normalize: inputs are [0, 1] floats, scaled to the uint8 range before extraction.
        num_features: declared feature dimension; the states then exist before the first update.
    """

    __jit_ineligible__ = True  # float64 eigendecompositions at compute
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        feature: Union[Callable, int, None] = None,
        reset_real_features: bool = True,
        normalize: bool = False,
        num_features: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(feature, int):
            if num_features is None:
                num_features = feature
            feature = _inception(self, feature)
        self.feature_extractor = feature
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self._initialized = False
        if num_features is not None:
            self._init_states(int(num_features))

    def _init_states(self, d: int) -> None:
        self.add_state("real_features_sum", torch.zeros(d), "sum")
        self.add_state("real_features_cov_sum", torch.zeros((d, d)), "sum")
        self.add_state("real_features_num_samples", torch.zeros((), dtype=count_dtype()), "sum")
        self.add_state("fake_features_sum", torch.zeros(d), "sum")
        self.add_state("fake_features_cov_sum", torch.zeros((d, d)), "sum")
        self.add_state("fake_features_num_samples", torch.zeros((), dtype=count_dtype()), "sum")
        self._initialized = True

    def _extract(self, imgs: Any) -> Any:
        if self.normalize:
            imgs = imgs * 255.0
        return self.feature_extractor(imgs) if self.feature_extractor is not None else imgs

    def update(self, imgs: Any, real: bool) -> None:
        """Update with an image batch (features extracted) or a feature batch."""
        self._update_features(self._extract(imgs), real)

    def _update_features(self, feats: Any, real: bool) -> None:
        feats = torch.as_tensor(feats).to(self.device, torch.float64)
        if feats.ndim != 2:
            raise ValueError(f"Expected features to be 2d (N, D) but got shape {tuple(feats.shape)}")
        if not self._initialized:
            self._init_states(feats.shape[1])
        expected = self._state["real_features_sum"].shape[0]
        if feats.shape[1] != expected:
            raise ValueError(
                f"Expected features of dimension {expected} (from `num_features`/first update)"
                f" but the extractor returned dimension {feats.shape[1]}"
            )
        key = "real" if real else "fake"
        self._state[f"{key}_features_sum"] = self._state[f"{key}_features_sum"] + feats.sum(0).to(torch.float32)
        self._state[f"{key}_features_cov_sum"] = self._state[f"{key}_features_cov_sum"] + (feats.T @ feats).to(
            torch.float32)
        self._state[f"{key}_features_num_samples"] = self._state[f"{key}_features_num_samples"] + feats.shape[0]

    def compute(self) -> torch.Tensor:
        """FID from the accumulated statistics, in float64 on the metric's device."""
        n_real = int(self.real_features_num_samples) if self._initialized else 0
        n_fake = int(self.fake_features_num_samples) if self._initialized else 0
        if n_real < 2 or n_fake < 2:
            raise RuntimeError("More than one sample is required for both the real and fake distributions")
        f64 = torch.float64
        val = _fid_from_stats(
            self.real_features_sum.to(f64), self.real_features_cov_sum.to(f64), n_real,
            self.fake_features_sum.to(f64), self.fake_features_cov_sum.to(f64), n_fake,
        )
        return val.to(torch.float32)

    def reset(self) -> None:
        """Reset; with ``reset_real_features=False`` the real-set statistics stay."""
        if not self._initialized or self.reset_real_features:
            return super().reset()
        keep = {k: self._state[k] for k in ("real_features_sum", "real_features_cov_sum", "real_features_num_samples")}
        super().reset()
        self._state.update(keep)


class KernelInceptionDistance(Metric):
    """Kernel Inception Distance: polynomial-kernel MMD over random feature subsets."""

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        feature: Union[Callable, int, None] = None,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(feature, int):
            feature = _inception(self, feature)
        self.feature_extractor = feature
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subsets = subsets
        self.subset_size = subset_size
        self.degree = degree
        self.gamma = gamma
        self.coef = coef
        self.reset_real_features = reset_real_features
        self.normalize = normalize
        self.add_state("real_features", [], dist_reduce_fx=None)
        self.add_state("fake_features", [], dist_reduce_fx=None)

    def update(self, imgs: Any, real: bool) -> None:
        """Update with an image batch (features extracted) or a feature batch."""
        if self.normalize:
            imgs = imgs * 255.0
        feats = self.feature_extractor(imgs) if self.feature_extractor is not None else imgs
        feats = torch.as_tensor(feats).to(self.device, torch.float32)
        (self.real_features if real else self.fake_features).append(feats)

    def reset(self) -> None:
        """Reset; with ``reset_real_features=False`` the accumulated real features stay."""
        if self.reset_real_features:
            return super().reset()
        keep = list(self.real_features)
        super().reset()
        self._state["real_features"] = keep

    def _poly_kernel(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        gamma = self.gamma if self.gamma is not None else 1.0 / x.shape[1]
        return (x @ y.T * gamma + self.coef) ** self.degree

    def _mmd(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        m = x.shape[0]
        k_xx = self._poly_kernel(x, x)
        k_yy = self._poly_kernel(y, y)
        k_xy = self._poly_kernel(x, y)
        diag_sum_xx = (k_xx.sum() - torch.trace(k_xx)) / (m * (m - 1))
        diag_sum_yy = (k_yy.sum() - torch.trace(k_yy)) / (m * (m - 1))
        return diag_sum_xx + diag_sum_yy - 2 * k_xy.mean()

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """KID mean and std over random subsets, in float64 on the metric's device."""
        real = dim_zero_cat(self.real_features).to(torch.float64)
        fake = dim_zero_cat(self.fake_features).to(torch.float64)
        n_real, n_fake = real.shape[0], fake.shape[0]
        if n_real < self.subset_size or n_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        rng = np.random.RandomState(0)
        draws = [(rng.choice(n_real, self.subset_size, replace=False), rng.choice(n_fake, self.subset_size,
                                                                                  replace=False))
                 for _ in range(self.subsets)]
        index = torch.as_tensor(np.asarray(draws), device=real.device)  # (subsets, 2, subset_size): one copy
        vals = torch.stack([self._mmd(real[index[i, 0]], fake[index[i, 1]]) for i in range(self.subsets)])
        return vals.mean().to(torch.float32), vals.std(correction=1).to(torch.float32)


class InceptionScore(Metric):
    """Inception Score: exp(E KL(p(y|x) || p(y))) over ``splits`` parts of the samples."""

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, feature: Union[Callable, int, None] = None, splits: int = 10,
                 normalize: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if isinstance(feature, (int, str)):
            raise ModuleNotFoundError("Integer `feature` needs downloaded InceptionV3 weights (unavailable offline).")
        self.feature_extractor = feature
        self.splits = splits
        self.normalize = normalize
        self.add_state("features", [], dist_reduce_fx=None)

    def update(self, imgs: Any) -> None:
        """Update with an image batch (logits extracted) or a logit batch."""
        if self.normalize:
            imgs = imgs * 255.0
        feats = self.feature_extractor(imgs) if self.feature_extractor is not None else imgs
        self.features.append(torch.as_tensor(feats).to(self.device, torch.float32))

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """IS mean and std over the splits."""
        probs = torch.softmax(torch.cat(self.features), dim=-1)
        scores = []
        for ix in np.array_split(np.arange(probs.shape[0]), self.splits):
            p = probs[int(ix[0]): int(ix[-1]) + 1] if len(ix) else probs[:0]
            marginal = p.mean(0, keepdim=True)
            kl = torch.sum(p * (torch.log(p + 1e-10) - torch.log(marginal + 1e-10)), dim=1)
            scores.append(torch.exp(kl.mean()))
        scores64 = torch.stack(scores).to(torch.float64)
        return scores64.mean().to(torch.float32), scores64.std(correction=1).to(torch.float32)


class MemorizationInformedFrechetInceptionDistance(FrechetInceptionDistance):
    """MiFID: FID scaled by a memorization penalty.

    The full feature sets (for the per-sample nearest-cosine memorization distance) are "cat" list states
    beside the streaming FID statistics, so merge, pickling, sync and forward handle them as KID's.
    """

    def __init__(self, feature: Union[Callable, int, None] = None, cosine_distance_eps: float = 0.1,
                 **kwargs: Any) -> None:
        super().__init__(feature=feature, **kwargs)
        if not (isinstance(cosine_distance_eps, float) and 0 < cosine_distance_eps <= 1):
            raise ValueError("Argument `cosine_distance_eps` expected to be a float greater than 0 and less than 1")
        self.cosine_distance_eps = cosine_distance_eps
        self.add_state("real_feature_store", [], dist_reduce_fx="cat")
        self.add_state("fake_feature_store", [], dist_reduce_fx="cat")

    def update(self, imgs: Any, real: bool) -> None:
        """Update the streaming statistics and keep the features for the memorization term."""
        feats = self._extract(imgs)  # one extraction, shared by the FID statistics and the memorization term
        self._update_features(feats, real)
        (self.real_feature_store if real else self.fake_feature_store).append(
            torch.as_tensor(feats).to(self.device, torch.float32))

    def compute(self) -> torch.Tensor:
        """FID / max(memorization distance, eps)."""
        fid = super().compute().to(torch.float64)
        real = dim_zero_cat(self.real_feature_store).to(torch.float64)
        fake = dim_zero_cat(self.fake_feature_store).to(torch.float64)
        real_n = real / torch.linalg.norm(real, dim=1, keepdim=True).clamp(min=1e-12)
        fake_n = fake / torch.linalg.norm(fake, dim=1, keepdim=True).clamp(min=1e-12)
        mem_dist = (1 - (fake_n @ real_n.T).abs()).min(dim=1).values.mean()
        penalty = torch.where(mem_dist < self.cosine_distance_eps, mem_dist, torch.ones_like(mem_dist))
        return (fid / penalty).to(torch.float32)

    def forward(self, *args: Any, **kwargs: Any) -> torch.Tensor:
        """Generic forward with all-or-nothing rollback.

        ``update`` is one-sided (real XOR fake), so the batch-local compute raises whenever the batch lacks the
        other distribution; the whole forward is then rolled back (state, counters, sync flags).
        """
        state_backup = self._copy_state()
        count_backup = self._update_count
        try:
            return super().forward(*args, **kwargs)
        except Exception:
            self.__dict__["_state"] = state_backup  # donlint: disable=ML001 — the rollback restores its own backup
            self._update_count = count_backup
            self._computed = None
            self._to_sync = self.sync_on_compute
            self._should_unsync = True
            self._is_synced = False
            raise

    def reset(self) -> None:
        """Reset; with ``reset_real_features=False`` the real statistics AND the real store stay."""
        if self._initialized and not self.reset_real_features:
            keep = list(self.real_feature_store)
            super().reset()
            self._state["real_feature_store"] = keep
        else:
            super().reset()
