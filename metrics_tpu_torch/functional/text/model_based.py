"""Functional entry points for the model-based text metrics (counterpart of
``metrics_tpu/functional/text/model_based.py``).

Single-shot wrappers over the modular metrics (``metrics_tpu_torch/text/model_based.py``): construct, update
once, compute. Encoders and distribution functions are injected as there; ``device=`` and the other
``Metric`` keywords pass through ``**kwargs`` ("cuda" when omitted).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

__all__ = ["bert_score", "infolm"]


def bert_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    model_name_or_path: Optional[str] = None,
    encoder: Optional[Callable] = None,
    idf: bool = False,
    rescale_with_baseline: bool = False,
    **kwargs: Any,
) -> Dict[str, Tensor]:
    """Greedy-cosine-matching BERTScore precision, recall and F1.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> vocab = {w: rng.rand(8) for w in "the cat sat on mat".split()}
    >>> enc = lambda texts: [np.stack([vocab[w] for w in t.split()]) for t in texts]
    >>> out = bert_score(["the cat sat"], ["the cat sat"], encoder=enc, device="cpu")
    >>> round(float(out["f1"]), 4)
    1.0
    """
    from metrics_tpu_torch.text.model_based import BERTScore

    metric = BERTScore(
        model_name_or_path=model_name_or_path,
        encoder=encoder,
        idf=idf,
        rescale_with_baseline=rescale_with_baseline,
        **kwargs,
    )
    metric.update(preds, target)
    return metric.compute()


def infolm(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    model_name_or_path: Optional[str] = "bert-base-uncased",
    temperature: float = 0.25,
    information_measure: str = "kl_divergence",
    idf: bool = True,
    alpha: Optional[float] = None,
    beta: Optional[float] = None,
    distribution_fn: Optional[Callable] = None,
    return_sentence_level_score: bool = False,
    **kwargs: Any,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """InfoLM divergence between masked-LM token distributions.

    Requires ``distribution_fn`` (a list of strings → per-text ``(T_i, V)`` token probabilities), as the
    modular :class:`~metrics_tpu_torch.text.model_based.InfoLM` does. ``temperature`` re-tempers the injected
    distributions per token (``p^(1/T)`` renormalised); the default is 0.25.
    """
    from metrics_tpu_torch.text.model_based import InfoLM

    metric = InfoLM(
        model_name_or_path=model_name_or_path,
        distribution_fn=distribution_fn,
        information_measure=information_measure,
        idf=idf,
        alpha=0.25 if alpha is None else alpha,
        beta=0.25 if beta is None else beta,
        temperature=temperature,
        **kwargs,
    )
    metric.update(preds, target)
    if return_sentence_level_score:
        # one distribution_fn pass: the corpus score is the mean of the float32 sentence scores
        sentences = metric.compute_sentence_scores()
        corpus = sentences.to(torch.float64).mean() if sentences.numel() else sentences.new_zeros((), dtype=torch.float64)
        return corpus.to(torch.float32), sentences
    return metric.compute()
