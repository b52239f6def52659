"""CLIP-based multimodal metrics with injectable encoders (counterpart of
``metrics_tpu/multimodal/clip_score.py``).

The caller injects ``image_encoder``/``text_encoder`` callables returning embeddings, or both default to a
local Hugging Face CLIP checkpoint (:func:`metrics_tpu_torch.models.hub.load_clip`) on the metric's device;
the metric owns the score math.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.multimodal.clip_score import _embedding, _unit
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype
from metrics_tpu_torch.utils.data import dim_zero_cat


class CLIPScore(Metric):
    """CLIPScore: 100 · max(cos(img_emb, txt_emb), 0), the clamp applied once to the mean at compute.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> img_enc = lambda imgs: rng.rand(len(imgs), 8).astype(np.float32)
    >>> txt_enc = lambda txts: rng.rand(len(txts), 8).astype(np.float32)
    >>> metric = CLIPScore(image_encoder=img_enc, text_encoder=txt_enc, device="cpu")
    >>> metric.update([object(), object()], ["a cat", "a dog"])
    >>> float(metric.compute()) > 0
    True
    """

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0
    score: Tensor
    n_samples: Tensor

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        image_encoder: Optional[Callable] = None,
        text_encoder: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if image_encoder is None or text_encoder is None:
            # a local Hugging Face CLIP checkpoint; raises when none is on disk
            from metrics_tpu_torch.models.hub import load_clip

            image_encoder, text_encoder = load_clip(
                model_name_or_path or "openai/clip-vit-large-patch14", device=self.device
            )
        self.image_encoder = image_encoder
        self.text_encoder = text_encoder
        self.add_state("score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    def update(self, images: Union[Tensor, Sequence], text: Union[str, Sequence[str]]) -> None:
        """Update with images and matching captions."""
        text_ = [text] if isinstance(text, str) else list(text)
        if hasattr(images, "ndim") and images.ndim == 3:
            images = images[None]
        if len(images) != len(text_):
            raise ValueError(
                f"Expected the number of images and text examples to be the same but got {len(images)} and {len(text_)}"
            )
        img_emb = _unit(_embedding(self.image_encoder(images), self.device))
        txt_emb = _unit(_embedding(self.text_encoder(text_), self.device))
        score = 100 * (img_emb * txt_emb).sum(-1)
        # the raw sum: the clamp applies once, to the mean, at compute
        self.score = self.score + score.sum()
        self.n_samples = self.n_samples + score.shape[0]

    def compute(self) -> Tensor:
        """Average CLIPScore, clamped at 0."""
        return (self.score / self.n_samples).clamp_min(0.0).to(torch.float32)


class CLIPImageQualityAssessment(Metric):
    """CLIP-IQA: a softmax over each image's similarities to paired positive and negative prompts.

    ``update`` hands the images to the image encoder as they come: unlike
    :func:`~metrics_tpu_torch.functional.multimodal.clip_image_quality_assessment`, it does not divide by a
    ``data_range`` (as in the JAX package).

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> img_enc = lambda imgs: rng.rand(len(imgs), 8).astype(np.float32)
    >>> txt_enc = lambda txts: rng.rand(len(txts), 8).astype(np.float32)
    >>> metric = CLIPImageQualityAssessment(image_encoder=img_enc, text_encoder=txt_enc, device="cpu")
    >>> metric.update(torch.zeros(2, 3, 8, 8))
    >>> out = metric.compute()
    >>> bool(((out >= 0) & (out <= 1)).all())
    True
    """

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
        image_encoder: Optional[Callable] = None,
        text_encoder: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if image_encoder is None or text_encoder is None:
            from metrics_tpu_torch.models.hub import load_clip

            image_encoder, text_encoder = load_clip(
                model_name_or_path or "openai/clip-vit-large-patch14", device=self.device
            )
        self.image_encoder = image_encoder
        self.text_encoder = text_encoder
        from metrics_tpu_torch.functional.multimodal.clip_iqa import _resolve_prompts

        self.prompt_pairs, self.prompt_names = _resolve_prompts(prompts)
        self.add_state("scores", [], dist_reduce_fx="cat")

    def update(self, images: Tensor) -> None:
        """Update with an image batch."""
        from metrics_tpu_torch.functional.multimodal.clip_iqa import _prompt_probs

        img_emb = _unit(_embedding(self.image_encoder(images), self.device))
        self.scores.append(torch.stack(_prompt_probs(img_emb, self.prompt_pairs, self.text_encoder), dim=-1))

    def compute(self) -> Union[Tensor, Dict[str, Tensor]]:
        """Per-image scores (a single prompt) or a dict of per-prompt score vectors."""
        scores = dim_zero_cat(self.scores)
        if len(self.prompt_names) == 1:
            return scores[:, 0]
        return {name: scores[:, i] for i, name in enumerate(self.prompt_names)}
