"""chrF and chrF++ (counterpart of ``metrics_tpu/functional/text/chrf.py``): character n-gram F-scores, with
word n-grams for chrF++, the best reference of each sentence counted; all on the host in float64, each score
rounded once to float32."""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _ngram_counts, _tokenize_words
from metrics_tpu_torch.metric import resolve_device


def _chrf_counters(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_char_order: int,
    n_word_order: int,
    lowercase: bool,
    whitespace: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-order (matches, prediction totals, target totals) summed over the corpus, each sentence counted
    against its best-scoring reference (F with beta 2; the first reference on a tie)."""
    total_orders = n_char_order + n_word_order
    matches = np.zeros(total_orders)
    pred_totals = np.zeros(total_orders)
    target_totals = np.zeros(total_orders)
    for pred, refs in zip(preds, target):
        if lowercase:
            pred = pred.lower()
            refs = [r.lower() for r in refs]
        p_char = pred if whitespace else pred.replace(" ", "")
        p_char_counts = _ngram_counts(list(p_char), n_char_order)
        p_word_counts = _ngram_counts(_tokenize_words(pred), n_word_order) if n_word_order else Counter()
        best: Tuple = (-1.0, None, None, None)
        for ref in refs:
            r_char = ref if whitespace else ref.replace(" ", "")
            r_char_counts = _ngram_counts(list(r_char), n_char_order)
            r_word_counts = _ngram_counts(_tokenize_words(ref), n_word_order) if n_word_order else Counter()
            m = np.zeros(total_orders)
            pt = np.zeros(total_orders)
            tt = np.zeros(total_orders)
            for counts_p, counts_r, offset in (
                (p_char_counts, r_char_counts, 0),
                (p_word_counts, r_word_counts, n_char_order),
            ):
                clipped = counts_p & counts_r
                for k, c in clipped.items():
                    m[offset + len(k) - 1] += c
                for k, c in counts_p.items():
                    pt[offset + len(k) - 1] += c
                for k, c in counts_r.items():
                    tt[offset + len(k) - 1] += c
            p_vec = np.divide(m, pt, out=np.zeros_like(m), where=pt > 0)
            r_vec = np.divide(m, tt, out=np.zeros_like(m), where=tt > 0)
            f_vec = np.divide(5 * p_vec * r_vec, 4 * p_vec + r_vec, out=np.zeros_like(m), where=(4 * p_vec + r_vec) > 0)
            score = f_vec.mean()
            if score > best[0]:
                best = (score, m, pt, tt)
        matches += best[1]
        pred_totals += best[2]
        target_totals += best[3]
    return matches, pred_totals, target_totals


def _chrf_value(m: np.ndarray, pt: np.ndarray, tt: np.ndarray, beta: float) -> float:
    """The mean over orders of the F-beta of the order's precision and recall, in float64."""
    p_vec = np.divide(m, pt, out=np.zeros_like(m), where=pt > 0)
    r_vec = np.divide(m, tt, out=np.zeros_like(m), where=tt > 0)
    b2 = beta**2
    denom = b2 * p_vec + r_vec
    f_vec = np.divide((1 + b2) * p_vec * r_vec, denom, out=np.zeros_like(m), where=denom > 0)
    return float(f_vec.mean())


def _validate_orders(n_char_order: int, n_word_order: int, beta: float) -> None:
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    *,
    device: Optional[Union[str, torch.device]] = None,
):
    """chrF (``n_word_order=0``) or chrF++ of a corpus; with ``return_sentence_level_score`` also each
    sentence's own score.

    >>> preds = ['the cat is on the mat']
    >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
    >>> round(float(chrf_score(preds, target, device="cpu")), 4)
    0.864
    """
    _validate_orders(n_char_order, n_word_order, beta)
    device = resolve_device(device)
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    counts = _chrf_counters(preds_, target_, n_char_order, n_word_order, lowercase, whitespace)
    corpus = _chrf_value(*counts, beta)
    if not return_sentence_level_score:
        return torch.tensor(corpus, dtype=torch.float32, device=device)
    sentence = [_chrf_value(*_chrf_counters([p], [refs], n_char_order, n_word_order, lowercase, whitespace), beta)
                for p, refs in zip(preds_, target_)]
    values = torch.from_numpy(np.asarray([corpus] + sentence, dtype=np.float32)).to(device)
    return values[0], values[1:]
