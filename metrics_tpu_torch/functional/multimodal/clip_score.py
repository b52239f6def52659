"""Functional CLIPScore (counterpart of ``metrics_tpu/functional/multimodal/clip_score.py``).

The score math (embed, normalise, cosine x 100, mean over pairs, clamp at 0 after the mean) is torch; the
encoders are injected callables, so the metric works without weights. When either is omitted, both default to
a local Hugging Face CLIP checkpoint through :func:`metrics_tpu_torch.models.hub.load_clip`, the loader the
modular ``CLIPScore`` uses. The score is computed on ``device`` ("cuda" when omitted).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device

__all__ = ["clip_score"]

_Device = Optional[Union[str, torch.device]]


def _is_text(x: object) -> bool:
    return isinstance(x, str) or (
        isinstance(x, (list, tuple)) and len(x) > 0 and isinstance(x[0], str)
    )


def _as_batch(x: Union[Tensor, Sequence, str]) -> Union[List[str], Sequence]:
    if isinstance(x, str):
        return [x]
    if hasattr(x, "ndim") and getattr(x, "ndim", 0) == 3:
        return x[None]
    return x


def _embedding(x: Any, device: torch.device) -> Tensor:
    """An encoder's output as a tensor on ``device``; float64 becomes the default float type, as the JAX
    package's ``jnp.asarray`` makes it float32 under x32."""
    t = x if isinstance(x, Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device, torch.get_default_dtype() if t.dtype == torch.float64 else t.dtype)


def _unit(x: Tensor) -> Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def clip_score(
    source: Union[Tensor, Sequence, str],
    target: Union[Tensor, Sequence, str],
    model_name_or_path: str = "openai/clip-vit-large-patch14",
    image_encoder: Optional[Callable] = None,
    text_encoder: Optional[Callable] = None,
    *,
    device: _Device = None,
) -> Tensor:
    """CLIPScore(S, T) = max(mean over pairs of 100 · cos(E_S, E_T), 0): the clamp applies after the mean.

    Either slot can hold images (an ``(N, C, H, W)`` tensor or a list of ``(C, H, W)`` images) or text (a
    caption or a list of captions): image-text, image-image and text-text comparisons all work.

    >>> import numpy as np
    >>> rng = np.random.RandomState(0)
    >>> enc = lambda xs: rng.rand(len(xs), 16).astype(np.float32)
    >>> s = clip_score(torch.zeros(2, 3, 8, 8), ["a cat", "a dog"], image_encoder=enc, text_encoder=enc,
    ...                device="cpu")
    >>> bool((s >= 0) & (s <= 100))
    True
    """
    dev = resolve_device(device)
    if image_encoder is None or text_encoder is None:
        from metrics_tpu_torch.models.hub import load_clip

        default_img, default_txt = load_clip(model_name_or_path, device=dev)
        image_encoder = image_encoder or default_img
        text_encoder = text_encoder or default_txt

    def _embed(x: Union[Tensor, Sequence, str]) -> Tuple[Tensor, int]:
        batch = _as_batch(x)
        enc = text_encoder if _is_text(batch) else image_encoder
        return _unit(_embedding(enc(batch), dev)), len(batch)

    src_emb, n_src = _embed(source)
    tgt_emb, n_tgt = _embed(target)
    if n_src != n_tgt:
        raise ValueError(
            f"Expected the number of source and target examples to be the same but got {n_src} and {n_tgt}"
        )
    score = 100.0 * (src_emb * tgt_emb).sum(-1)
    return score.mean().clamp_min(0.0).to(torch.float32)
