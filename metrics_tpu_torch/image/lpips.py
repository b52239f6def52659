"""LPIPS and PerceptualPathLength with injectable backbones (counterpart of ``metrics_tpu/image/lpips.py``).

The per-layer feature function is injected, or the named LPIPS tower and heads are resolved from local
weights (:func:`metrics_tpu_torch.models.hub.load_lpips`) on the metric's device. The metric implements the
LPIPS distance (unit-normalize per channel, squared difference, spatial mean, sum over layers).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype

__all__ = ["LearnedPerceptualImagePatchSimilarity", "PerceptualPathLength", "perceptual_path_length"]


def _lpips_distance(feats_a: Sequence[torch.Tensor], feats_b: Sequence[torch.Tensor],
                    weights: Optional[Sequence[Callable]] = None) -> torch.Tensor:
    """LPIPS distance from per-layer feature maps (N, C, H, W)."""
    total = None
    for i, (fa, fb) in enumerate(zip(feats_a, feats_b)):
        na = fa / torch.linalg.norm(fa, dim=1, keepdim=True).clamp(min=1e-10)
        nb = fb / torch.linalg.norm(fb, dim=1, keepdim=True).clamp(min=1e-10)
        diff = (na - nb) ** 2
        if weights is not None:
            diff = weights[i](diff)
            layer = diff.reshape(diff.shape[0], -1).mean(-1) if diff.ndim > 1 else diff
        else:
            layer = diff.sum(1).reshape(diff.shape[0], -1).mean(-1)
        total = layer if total is None else total + layer
    return total


class LearnedPerceptualImagePatchSimilarity(Metric):
    """LPIPS.

    Args:
        net: a function mapping an image batch to a LIST of per-layer feature maps; None resolves the
            ``net_type`` tower and heads from local weights.
        reduction: 'mean' or 'sum' over the accumulated pairs.
        normalize: inputs are in [0, 1] (else [-1, 1]).
    """

    __jit_ineligible__ = True
    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        net: Optional[Callable] = None,
        net_type: str = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if net_type not in ("alex", "vgg", "squeeze"):
            raise ValueError(f"Argument `net_type` must be one of 'alex', 'vgg', 'squeeze', but got {net_type}")
        self._scorer: Optional[Callable] = None
        if net is None:
            from metrics_tpu_torch.models.hub import load_lpips

            self._scorer = load_lpips(net_type, device=self.device)
        self.net = net
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Argument `reduction` must be one of 'sum' or 'mean' but got {reduction}")
        self.reduction = reduction
        self.normalize = normalize
        self.add_state("sum_scores", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    def update(self, img1: Any, img2: Any) -> None:
        """Update with a pair of image batches."""
        from metrics_tpu_torch.functional.image.perceptual import _validate_lpips_images

        img1, img2 = torch.as_tensor(img1), torch.as_tensor(img2)
        _validate_lpips_images(img1, img2, self.normalize)
        if self._scorer is not None:
            d = self._scorer(img1, img2, self.normalize)
        else:
            if self.normalize:
                img1 = 2 * img1 - 1
                img2 = 2 * img2 - 1
            d = _lpips_distance(self.net(img1), self.net(img2))
        d = d.to(self.device)
        self.sum_scores = self.sum_scores + d.sum()
        self.total = self.total + d.shape[0]

    def compute(self) -> torch.Tensor:
        if self.reduction == "mean":
            return (self.sum_scores / self.total).to(torch.float32)
        return self.sum_scores.to(torch.float32)


def _interpolate_latents(z1: torch.Tensor, z2: torch.Tensor, epsilon: float, method: str) -> torch.Tensor:
    """ε-step from ``z1`` toward ``z2``."""
    eps = 1e-7
    if z1.shape != z2.shape:
        raise ValueError("Latents must have the same shape.")
    if method == "lerp":
        return z1 + (z2 - z1) * epsilon
    if method in ("slerp_any", "slerp_unit"):
        n1 = z1 / torch.sqrt((z1 ** 2).sum(-1, keepdim=True)).clamp(min=eps)
        n2 = z2 / torch.sqrt((z2 ** 2).sum(-1, keepdim=True)).clamp(min=eps)
        d = (n1 * n2).sum(-1, keepdim=True)
        degenerate = (
            (torch.linalg.norm(n1, dim=-1, keepdim=True) < eps)
            | (torch.linalg.norm(n2, dim=-1, keepdim=True) < eps)
            | (d > 1 - eps)
            | (d < -1 + eps)
        )
        omega = torch.arccos(d.clamp(-1.0, 1.0))
        denom = torch.sin(omega).clamp(min=eps)
        out = (torch.sin((1 - epsilon) * omega) / denom) * z1 + (torch.sin(epsilon * omega) / denom) * z2
        out = torch.where(degenerate, z1 + (z2 - z1) * epsilon, out)
        if method == "slerp_unit":
            out = out / torch.sqrt((out ** 2).sum(-1, keepdim=True)).clamp(min=eps)
        return out
    raise ValueError(f"Interpolation method {method} not supported. Choose from 'lerp', 'slerp_any', 'slerp_unit'.")


def _resize_images(x: torch.Tensor, size: Optional[int]) -> torch.Tensor:
    """Resize (N, C, H, W) images to ``(size, size)`` by the reference's rule: ``area`` (adaptive average
    pooling) when BOTH dims are strictly larger than ``size``, bilinear (align_corners=False) otherwise."""
    if size is None:
        return x
    h, w = x.shape[2], x.shape[3]
    if h > size and w > size:
        return F.adaptive_avg_pool2d(x, (size, size))
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=False)


def _ppl_validate_args(
    num_samples: int,
    conditional: bool,
    batch_size: int,
    interpolation_method: str,
    epsilon: float,
    resize: Optional[int],
    lower_discard: Optional[float],
    upper_discard: Optional[float],
) -> None:
    if not (isinstance(num_samples, int) and num_samples > 0):
        raise ValueError(f"Argument `num_samples` must be a positive integer, but got {num_samples}.")
    if not isinstance(conditional, bool):
        raise ValueError(f"Argument `conditional` must be a boolean, but got {conditional}.")
    if not (isinstance(batch_size, int) and batch_size > 0):
        raise ValueError(f"Argument `batch_size` must be a positive integer, but got {batch_size}.")
    if interpolation_method not in ("lerp", "slerp_any", "slerp_unit"):
        raise ValueError(
            f"Argument `interpolation_method` must be one of 'lerp', 'slerp_any', 'slerp_unit',"
            f"got {interpolation_method}."
        )
    if not (isinstance(epsilon, float) and epsilon > 0):
        raise ValueError(f"Argument `epsilon` must be a positive float, but got {epsilon}.")
    if resize is not None and not (isinstance(resize, int) and resize > 0):
        raise ValueError(f"Argument `resize` must be a positive integer or `None`, but got {resize}.")
    if lower_discard is not None and not (isinstance(lower_discard, float) and 0 <= lower_discard <= 1):
        raise ValueError(
            f"Argument `lower_discard` must be a float between 0 and 1 or `None`, but got {lower_discard}."
        )
    if upper_discard is not None and not (isinstance(upper_discard, float) and 0 <= upper_discard <= 1):
        raise ValueError(
            f"Argument `upper_discard` must be a float between 0 and 1 or `None`, but got {upper_discard}."
        )


def _resolve_sim_net(sim_net: Any, resize: Optional[int], device: Any = None) -> Callable:
    """None or a name: the LPIPS scorer from local weights (inputs resized first); a function passes through."""
    if sim_net is None or isinstance(sim_net, str):
        name = "vgg" if sim_net is None else sim_net
        if name not in ("alex", "vgg", "squeeze"):
            raise ValueError(f"sim_net must be a callable or one of 'alex', 'vgg', 'squeeze', got {sim_net}")
        from metrics_tpu_torch.models.hub import load_lpips

        scorer = load_lpips(name, device=device)
        # resampling (bilinear or area) commutes with the scorer's per-channel affine input normalization
        # (resampling weights sum to 1), so resizing first equals the reference's resize inside its _LPIPS
        return lambda a, b: scorer(_resize_images(a, resize), _resize_images(b, resize), False)
    if not callable(sim_net):
        raise ValueError(f"sim_net must be a callable or one of 'alex', 'vgg', 'squeeze', got {sim_net}")
    return sim_net


def _validate_ppl_generator(generator: Any, conditional: bool) -> None:
    if not hasattr(generator, "sample"):
        raise NotImplementedError(
            "The generator must have a `sample` method with signature `sample(num_samples: int) -> Array` where the"
            " returned array has shape `(num_samples, z_size)`."
        )
    if not callable(generator.sample):
        raise ValueError("The generator's `sample` method must be callable.")
    if conditional and not hasattr(generator, "num_classes"):
        raise AttributeError("The generator must have a `num_classes` attribute when `conditional=True`.")
    if conditional and not isinstance(getattr(generator, "num_classes", None), int):
        raise ValueError("The generator's `num_classes` attribute must be an integer when `conditional=True`.")


def perceptual_path_length(
    generator: Any,
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 64,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
    sim_net: Optional[Callable] = None,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Perceptual path length of a generator.

    ``generator``: an object with ``sample(n) -> (n, z)`` latents and ``__call__(z[, labels]) -> images`` in
    [0, 255]. ``sim_net``: a similarity function ``(img1, img2) -> (N,)``; None resolves the vgg LPIPS from
    local weights on the latents' device. Only the built-in LPIPS path resizes its inputs to ``resize``.
    Conditional labels come from ``np.random.default_rng(seed)``, the JAX package's draws. The distances
    stay on the device until one read at the end; the tail discards are numpy's ``quantile(method="lower")``.

    Returns ``(mean, std, distances)`` after the tail discards.
    """
    _ppl_validate_args(
        num_samples, conditional, batch_size, interpolation_method, epsilon, resize, lower_discard, upper_discard
    )
    _validate_ppl_generator(generator, conditional)
    latent1 = torch.as_tensor(generator.sample(num_samples))
    sim_net = _resolve_sim_net(sim_net, resize, latent1.device)
    latent2 = torch.as_tensor(generator.sample(num_samples))
    latent2 = _interpolate_latents(latent1, latent2, epsilon, interpolation_method)
    labels = None
    if conditional:
        labels = torch.as_tensor(np.random.default_rng(seed).integers(0, generator.num_classes, (num_samples,)),
                                 device=latent1.device)

    distances: List[torch.Tensor] = []
    for i in range(int(np.ceil(num_samples / batch_size))):
        b1 = latent1[i * batch_size: (i + 1) * batch_size]
        b2 = latent2[i * batch_size: (i + 1) * batch_size]
        if conditional:
            lab = labels[i * batch_size: (i + 1) * batch_size]
            outputs = generator(torch.cat([b1, b2], 0), torch.cat([lab, lab], 0))
        else:
            outputs = generator(torch.cat([b1, b2], 0))
        out1, out2 = torch.chunk(torch.as_tensor(outputs), 2, dim=0)
        # rescale to the LPIPS domain: [0, 255] -> [-1, 1]
        out1 = 2 * (out1 / 255) - 1
        out2 = 2 * (out2 / 255) - 1
        distances.append(torch.as_tensor(sim_net(out1, out2)).reshape(-1) / epsilon ** 2)

    d = torch.cat(distances).detach().cpu().numpy()
    lower = np.quantile(d, lower_discard, method="lower") if lower_discard is not None else 0.0
    upper = np.quantile(d, upper_discard, method="lower") if upper_discard is not None else d.max()
    kept = d[(d >= lower) & (d <= upper)]
    return (
        torch.tensor(kept.mean(), dtype=torch.float32),
        torch.tensor(kept.std(ddof=1), dtype=torch.float32),
        torch.from_numpy(kept),
    )


class PerceptualPathLength(Metric):
    """Perceptual Path Length.

    ``update(generator)`` stores the generator; ``compute()`` samples ``num_samples`` latent pairs through it
    and returns ``(mean, std, distances)``. ``sim_net``: a similarity function ``(img1, img2) -> (N,)``; None
    resolves the named LPIPS from local weights on the metric's device, once, at construction.
    """

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    def __init__(
        self,
        num_samples: int = 10_000,
        conditional: bool = False,
        batch_size: int = 128,
        interpolation_method: str = "lerp",
        epsilon: float = 1e-4,
        resize: Optional[int] = 64,
        lower_discard: Optional[float] = 0.01,
        upper_discard: Optional[float] = 0.99,
        sim_net: Optional[Callable] = None,
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _ppl_validate_args(
            num_samples, conditional, batch_size, interpolation_method, epsilon, resize, lower_discard, upper_discard
        )
        self._sim = _resolve_sim_net(sim_net, resize, self.device)
        self.num_samples = num_samples
        self.conditional = conditional
        self.batch_size = batch_size
        self.interpolation_method = interpolation_method
        self.epsilon = epsilon
        self.resize = resize
        self.lower_discard = lower_discard
        self.upper_discard = upper_discard
        self.seed = seed
        self.generator: Optional[Any] = None

    def update(self, generator: Any) -> None:
        """Store the generator model (validated against the reference's contract)."""
        _validate_ppl_generator(generator, self.conditional)
        self.generator = generator

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sample latent pairs through the stored generator and compute PPL."""
        if self.generator is None:
            raise RuntimeError("`update(generator)` must be called before `compute()`.")
        return perceptual_path_length(
            generator=self.generator,
            num_samples=self.num_samples,
            conditional=self.conditional,
            batch_size=self.batch_size,
            interpolation_method=self.interpolation_method,
            epsilon=self.epsilon,
            resize=self.resize,
            lower_discard=self.lower_discard,
            upper_discard=self.upper_discard,
            sim_net=self._sim,
            seed=self.seed,
        )
