"""BLEU and SacreBLEU (counterpart of ``metrics_tpu/functional/text/bleu.py``).

The clipped n-gram matches are counted on the host in float64 numpy and round
once into float32; the score is computed from the four count vectors and two
lengths in float32 on the device, the JAX package's arithmetic step for step.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import (
    _ngram_counts,
    _tokenize_13a,
    _tokenize_chars,
    _tokenize_international,
    _tokenize_words,
    _tokenize_zh,
)
from metrics_tpu_torch.metric import resolve_device

_GATED_TOKENIZERS = {
    "ja-mecab": "MeCab + ipadic",
    "ko-mecab": "MeCab + mecab-ko-dic",
    "flores101": "sentencepiece + the flores101 model download",
    "flores200": "sentencepiece + the flores200 model download",
}

_ALL_TOKENIZERS = ("none", "13a", "zh", "intl", "char", "ja-mecab", "ko-mecab", "flores101", "flores200")


def _get_tokenizer(tokenize: str):
    """The tokenizer of a SacreBLEU name; the MeCab and flores ones need packages and models that are not here."""
    if tokenize == "13a":
        return _tokenize_13a
    if tokenize == "char":
        return _tokenize_chars
    if tokenize == "none":
        return _tokenize_words
    if tokenize == "intl":
        return _tokenize_international
    if tokenize == "zh":
        return _tokenize_zh
    if tokenize in _GATED_TOKENIZERS:
        raise ModuleNotFoundError(
            f"Tokenizer '{tokenize}' requires {_GATED_TOKENIZERS[tokenize]}, which is not available"
            " in this offline build."
        )
    raise ValueError(f"Unsupported tokenizer selected. Please, choose one of {_ALL_TOKENIZERS}")


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: np.ndarray,
    denominator: np.ndarray,
    preds_len: float,
    target_len: float,
    n_gram: int = 4,
    tokenizer=_tokenize_words,
) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Add each sentence's clipped n-gram matches, n-gram counts and lengths (the closest reference length,
    the shorter one on a tie) to the host counters."""
    target_corpus = [[tokenizer(t) for t in ref_group] for ref_group in target]
    preds_tokens = [tokenizer(p) for p in preds]
    for pred, refs in zip(preds_tokens, target_corpus):
        preds_len += len(pred)
        target_len_list = [len(r) for r in refs]
        target_len += min(target_len_list, key=lambda x: (abs(x - len(pred)), x))
        pred_counter = _ngram_counts(pred, n_gram)
        target_counter: Counter = Counter()
        for r in refs:
            target_counter |= _ngram_counts(r, n_gram)
        clipped = pred_counter & target_counter
        for ngram, count in clipped.items():
            numerator[len(ngram) - 1] += count
        for ngram, count in pred_counter.items():
            denominator[len(ngram) - 1] += count
    return numerator, denominator, preds_len, target_len


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int = 4,
    weights: Optional[Sequence[float]] = None,
    smooth: bool = False,
) -> Tensor:
    """BLEU in float32 on the counters' device: the brevity penalty times the weighted geometric mean of the
    n-gram precisions (add-one smoothed above the unigrams when ``smooth``); 0 when nothing matched."""
    device = numerator.device
    weights_arr = torch.tensor(weights if weights is not None else [1.0 / n_gram] * n_gram, dtype=torch.float32,
                               device=device)
    num = numerator.to(torch.float32)
    den = denominator.to(torch.float32)
    preds_len, target_len = preds_len.to(torch.float32), target_len.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    if smooth:
        precision_scores = torch.cat([num[:1] / den[:1], (num[1:] + 1.0) / (den[1:] + 1.0)])
    else:
        precision_scores = torch.where(den > 0, num / torch.clamp(den, min=1.0), zero)
    positive = precision_scores > 0
    log_precision = torch.where(
        positive, torch.log(torch.where(positive, precision_scores, torch.ones_like(precision_scores))),
        torch.full_like(precision_scores, -float("inf")))
    geometric_mean = torch.exp(torch.sum(weights_arr * log_precision))
    brevity_penalty = torch.where(preds_len > target_len, torch.ones_like(preds_len),
                                  torch.exp(1 - target_len / preds_len))
    bleu = brevity_penalty * geometric_mean
    return torch.where(num.sum() == 0, zero, bleu)


def _corpus_tensors(numerator, denominator, preds_len, target_len, device) -> Tuple[Tensor, ...]:
    """The host counters rounded once to float32, in one copy to ``device``."""
    flat = np.concatenate([numerator, denominator, [preds_len, target_len]]).astype(np.float32)
    on = torch.from_numpy(flat).to(device)
    n = len(numerator)
    return on[:n], on[n:2 * n], on[2 * n], on[2 * n + 1]


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """BLEU of a corpus of whitespace-tokenized sentences, each with one or more references.

    >>> preds = ['the cat is on the mat']
    >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
    >>> bleu_score(preds, target, device="cpu")
    tensor(0.7598)
    """
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    counters = _bleu_score_update(preds_, target_, np.zeros(n_gram), np.zeros(n_gram), 0.0, 0.0, n_gram)
    num, den, p_len, t_len = _corpus_tensors(*counters, resolve_device(device))
    return _bleu_score_compute(p_len, t_len, num, den, n_gram, weights, smooth)


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """BLEU with one of SacreBLEU's tokenizers (``13a`` by default; ``none``, ``zh``, ``intl``, ``char``).

    >>> preds = ['the cat is on the mat']
    >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
    >>> sacre_bleu_score(preds, target, device="cpu")
    tensor(0.7598)
    """
    tokenizer = _get_tokenizer(tokenize)
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    preds_ = [p.lower() if lowercase else p for p in preds]
    target_ = [[(t.lower() if lowercase else t) for t in refs] for refs in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    counters = _bleu_score_update(preds_, target_, np.zeros(n_gram), np.zeros(n_gram), 0.0, 0.0, n_gram, tokenizer)
    num, den, p_len, t_len = _corpus_tensors(*counters, resolve_device(device))
    return _bleu_score_compute(p_len, t_len, num, den, n_gram, weights, smooth)
