"""ROUGE-N, ROUGE-L and ROUGE-Lsum (counterpart of ``metrics_tpu/functional/text/rouge.py``), on the host in
float64 as rouge_score tokenizes and scores; each mean rounded once to float32."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device

ALLOWED_ROUGE_KEYS = ("rouge1", "rouge2", "rouge3", "rouge4", "rouge5", "rouge6", "rouge7", "rouge8", "rouge9",
                      "rougeL", "rougeLsum")


def _rouge_tokenize(text: str, use_stemmer: bool = False) -> List[str]:
    """Lower case, split at every non-alphanumeric character; Porter-stem tokens longer than 3 (needs nltk)."""
    tokens = [t for t in re.split(r"[^a-z0-9]+", text.lower()) if t]
    if use_stemmer:
        from nltk.stem.porter import PorterStemmer

        stemmer = PorterStemmer()
        tokens = [stemmer.stem(t) if len(t) > 3 else t for t in tokens]
    return tokens


def _ngrams(tokens: Sequence[str], n: int) -> Dict[Tuple[str, ...], int]:
    out: Dict[Tuple[str, ...], int] = {}
    for i in range(len(tokens) - n + 1):
        key = tuple(tokens[i : i + n])
        out[key] = out.get(key, 0) + 1
    return out


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Length of the longest common subsequence, by numpy DP rows."""
    if not a or not b:
        return 0
    prev = np.zeros(len(b) + 1, dtype=np.int64)
    for x in a:
        cur = np.zeros(len(b) + 1, dtype=np.int64)
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return int(prev[-1])


def _prf(match: int, pred_total: int, target_total: int) -> Tuple[float, float, float]:
    p = match / pred_total if pred_total else 0.0
    r = match / target_total if target_total else 0.0
    f = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f


def _rouge_n(pred: List[str], target: List[str], n: int) -> Tuple[float, float, float]:
    pg, tg = _ngrams(pred, n), _ngrams(target, n)
    match = sum(min(c, tg.get(k, 0)) for k, c in pg.items())
    return _prf(match, sum(pg.values()), sum(tg.values()))


def _rouge_l(pred: List[str], target: List[str]) -> Tuple[float, float, float]:
    return _prf(_lcs_len(pred, target), len(pred), len(target))


def _lcs_positions(a: Sequence[str], b: Sequence[str]) -> set:
    """The positions of ``b`` that one longest common subsequence of ``a`` and ``b`` uses (DP backtrack)."""
    if not a or not b:
        return set()
    dp = np.zeros((len(a) + 1, len(b) + 1), dtype=np.int64)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            dp[i, j] = dp[i - 1, j - 1] + 1 if a[i - 1] == b[j - 1] else max(dp[i - 1, j], dp[i, j - 1])
    hits = set()
    i, j = len(a), len(b)
    while i > 0 and j > 0:
        if a[i - 1] == b[j - 1] and dp[i, j] == dp[i - 1, j - 1] + 1:
            hits.add(j - 1)
            i, j = i - 1, j - 1
        elif dp[i - 1, j] >= dp[i, j - 1]:
            i -= 1
        else:
            j -= 1
    return hits


def _rouge_lsum(pred_text: str, target_text: str, use_stemmer: bool = False) -> Tuple[float, float, float]:
    """Summary-level ROUGE-L: the union of LCS hits over newline-split sentences."""
    pred_sents = [_rouge_tokenize(s, use_stemmer) for s in pred_text.split("\n") if s]
    target_sents = [_rouge_tokenize(s, use_stemmer) for s in target_text.split("\n") if s]
    pred_total = sum(len(s) for s in pred_sents)
    target_total = sum(len(s) for s in target_sents)
    match = 0
    for t_sent in target_sents:
        union_hits: set = set()
        for p_sent in pred_sents:
            union_hits |= _lcs_positions(p_sent, t_sent)
        match += len(union_hits)
    return _prf(match, pred_total, target_total)


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Tensor]:
    """Precision, recall and F-measure of each ROUGE key, averaged over the sentences; with several references
    per sentence the best (``accumulate="best"``, by F-measure) or their mean (``"avg"``).

    >>> preds = "My name is John"
    >>> target = "Is your name John"
    >>> {k: round(float(v), 4) for k, v in sorted(rouge_score(preds, target, device="cpu").items())}
    {'rouge1_fmeasure': 0.75, 'rouge1_precision': 0.75, 'rouge1_recall': 0.75, ...}
    """
    if isinstance(rouge_keys, str):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {ALLOWED_ROUGE_KEYS}")
    if accumulate not in ("best", "avg"):
        raise ValueError(f"Argument `accumulate` must be 'best' or 'avg', got {accumulate}")
    device = resolve_device(device)
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [target] if isinstance(target, str) else list(target)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target_]

    results: Dict[str, List[float]] = {f"{k}_{s}": [] for k in rouge_keys for s in ("fmeasure", "precision", "recall")}
    for pred_text, refs in zip(preds_, target_):
        pred_tok = _rouge_tokenize(pred_text, use_stemmer)
        for key in rouge_keys:
            scores = []
            for ref_text in refs:
                ref_tok = _rouge_tokenize(ref_text, use_stemmer)
                if key == "rougeL":
                    scores.append(_rouge_l(pred_tok, ref_tok))
                elif key == "rougeLsum":
                    scores.append(_rouge_lsum(pred_text, ref_text, use_stemmer))
                else:
                    scores.append(_rouge_n(pred_tok, ref_tok, int(key[5:])))
            if accumulate == "best":
                p, r, f = max(scores, key=lambda x: x[2])
            else:
                p = float(np.mean([s[0] for s in scores]))
                r = float(np.mean([s[1] for s in scores]))
                f = float(np.mean([s[2] for s in scores]))
            results[f"{key}_precision"].append(p)
            results[f"{key}_recall"].append(r)
            results[f"{key}_fmeasure"].append(f)
    values = torch.from_numpy(np.asarray([np.mean(v) for v in results.values()], dtype=np.float32)).to(device)
    return dict(zip(results, values))
