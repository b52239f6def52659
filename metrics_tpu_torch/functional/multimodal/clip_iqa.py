"""Functional CLIP-IQA (counterpart of ``metrics_tpu/functional/multimodal/clip_iqa.py``).

The score is a softmax over each image's similarity to a (positive, negative) prompt pair, reported as the
probability of the positive prompt. The prompt table and its resolution are shared with the modular
``CLIPImageQualityAssessment``; encoders are injected, or default to a local Hugging Face CLIP checkpoint
through :func:`metrics_tpu_torch.models.hub.load_clip`. Scores are computed on ``device`` ("cuda" when
omitted).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.multimodal.clip_score import _Device, _embedding, _unit
from metrics_tpu_torch.metric import resolve_device

__all__ = ["clip_image_quality_assessment"]

# the prompt table; the modular ``CLIPImageQualityAssessment`` reads this same table and resolver
_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "warm": ("Warm photo.", "Cold photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}


def _resolve_prompts(
    prompts: Tuple[Union[str, Tuple[str, str]], ...],
) -> Tuple[List[Tuple[str, str]], List[str]]:
    resolved: List[Tuple[str, str]] = []
    names: List[str] = []
    n_custom = 0  # custom tuples are numbered by their own count
    for p in prompts:
        if isinstance(p, str):
            if p not in _PROMPTS:
                raise ValueError(
                    f"Unknown prompt {p!r}; expected one of {sorted(_PROMPTS)} or a (pos, neg) tuple"
                )
            resolved.append(_PROMPTS[p])
            names.append(p)
        elif isinstance(p, tuple) and len(p) == 2:
            resolved.append(p)
            names.append(f"user_defined_{n_custom}")
            n_custom += 1
        else:
            raise ValueError(
                "Argument `prompts` must contain strings or (positive, negative) tuples"
            )
    return resolved, names


def _prompt_probs(img_emb: Tensor, pairs: List[Tuple[str, str]], text_encoder: Callable) -> List[Tensor]:
    """Each prompt pair's ``(N,)`` probability of its positive prompt, a softmax over ``100 * img @ txt.T``."""
    out = []
    for pos, neg in pairs:
        txt_emb = _unit(_embedding(text_encoder([pos, neg]), img_emb.device))
        logits = 100.0 * img_emb @ txt_emb.T  # (N, 2)
        out.append(torch.softmax(logits, dim=-1)[:, 0])
    return out


def clip_image_quality_assessment(
    images: Tensor,
    model_name_or_path: str = "openai/clip-vit-large-patch14",
    data_range: float = 1.0,
    prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
    image_encoder: Optional[Callable] = None,
    text_encoder: Optional[Callable] = None,
    *,
    device: _Device = None,
) -> Union[Tensor, Dict[str, Tensor]]:
    """Per-image CLIP-IQA scores in [0, 1]: an ``(N,)`` tensor for a single prompt, else a dict keyed by prompt
    name. The images are divided by ``data_range`` before the image encoder sees them.

    >>> import numpy as np
    >>> rng = np.random.RandomState(0)
    >>> enc = lambda xs: rng.rand(len(xs), 16).astype(np.float32)
    >>> out = clip_image_quality_assessment(torch.zeros(2, 3, 8, 8), image_encoder=enc, text_encoder=enc,
    ...                                     device="cpu")
    >>> tuple(out.shape)
    (2,)
    """
    dev = resolve_device(device)
    if image_encoder is None or text_encoder is None:
        from metrics_tpu_torch.models.hub import load_clip

        default_img, default_txt = load_clip(model_name_or_path, device=dev)
        image_encoder = image_encoder or default_img
        text_encoder = text_encoder or default_txt
    pairs, names = _resolve_prompts(prompts)

    imgs = images[None] if getattr(images, "ndim", 0) == 3 else images
    imgs = imgs if isinstance(imgs, Tensor) else torch.from_numpy(np.asarray(imgs))
    imgs = imgs.to(dev, torch.float32) / float(data_range)
    img_emb = _unit(_embedding(image_encoder(imgs), dev))
    per_prompt = _prompt_probs(img_emb, pairs, text_encoder)
    if len(names) == 1:
        return per_prompt[0]
    return {name: vals for name, vals in zip(names, per_prompt)}
