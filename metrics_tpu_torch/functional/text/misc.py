"""SQuAD, TER and the extended edit distance (counterpart of ``metrics_tpu/functional/text/misc.py``).

All three work on strings on the host, in float64, with the JAX package's
algorithms copied step for step (TER's greedy shift search, EED's CDER grid
with long jumps); each score is rounded once to float32 and lands on
``device`` (``"cuda"`` when omitted; ``device="cpu"`` without a CUDA device).
"""

from __future__ import annotations

import re
import unicodedata
from collections import Counter
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
from torch import Tensor

from metrics_tpu_torch.functional.text.error_rates import _Device, _f32
from metrics_tpu_torch.functional.text.helper import _edit_distance, _squad_normalize
from metrics_tpu_torch.metric import resolve_device


def _with_sentences(corpus: float, sentences: List[float], return_sentence_level_score: bool, device: _Device):
    values = _f32([corpus] + sentences, resolve_device(device))
    return (values[0], values[1:]) if return_sentence_level_score else values[0]


# --------------------------------------------------------------------------- SQuAD
def _squad_f1(pred: str, answer: str) -> float:
    pred_tokens = _squad_normalize(pred).split()
    ans_tokens = _squad_normalize(answer).split()
    common = Counter(pred_tokens) & Counter(ans_tokens)
    num_same = sum(common.values())
    if not pred_tokens or not ans_tokens:
        return float(pred_tokens == ans_tokens)
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(ans_tokens)
    return 2 * precision * recall / (precision + recall)


def squad(preds: Union[Dict, List[Dict]], target: Union[Dict, List[Dict]], *, device: _Device = None) -> Dict[str, Tensor]:
    """SQuAD exact match and F1, in percent, each question against its best answer.

    >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
    >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
    >>> {k: float(v) for k, v in sorted(squad(preds, target, device="cpu").items())}
    {'exact_match': 100.0, 'f1': 100.0}
    """
    preds_ = [preds] if isinstance(preds, dict) else list(preds)
    target_ = [target] if isinstance(target, dict) else list(target)
    if len(preds_) != len(target_):
        raise ValueError("Expected argument `preds` and `target` to have the same length")
    pred_by_id = {}
    for p in preds_:
        if "prediction_text" not in p or "id" not in p:
            raise KeyError("Expected keys in a single prediction are 'prediction_text' and 'id'.")
        pred_by_id[p["id"]] = p["prediction_text"]
    em_total = 0.0
    f1_total = 0.0
    count = 0
    for t in target_:
        if "answers" not in t or "id" not in t:
            raise KeyError("Expected keys in a single target are 'answers' and 'id'.")
        answers = t["answers"]["text"]
        pred = pred_by_id.get(t["id"], "")
        em = max((float(_squad_normalize(pred) == _squad_normalize(a)) for a in answers), default=0.0)
        f1 = max((_squad_f1(pred, a) for a in answers), default=0.0)
        em_total += em
        f1_total += f1
        count += 1
    values = _f32([100.0 * em_total / count, 100.0 * f1_total / count], resolve_device(device))
    return {"exact_match": values[0], "f1": values[1]}


# --------------------------------------------------------------------------- TER
def _ter_preprocess(
    text: str, lowercase: bool, no_punctuation: bool, asian_support: bool, normalize: bool = False
) -> List[str]:
    if lowercase:
        text = text.lower()
    if asian_support:
        # CJK characters, hiragana, katakana and hangul become tokens of their own
        text = re.sub(r"([一-鿿぀-ヿ가-힯])", r" \1 ", text)
    if no_punctuation:
        text = re.sub(r"[\.,\?:;!\"\(\)]", "", text)
    elif normalize:
        # tercom's normalization: punctuation split into tokens of its own
        text = re.sub(r"([\.,\?:;!\"\(\)])", r" \1 ", text)
    return text.split()


def _ter_shifts(pred: List[str], ref: List[str], max_shift_size: int = 10, max_shift_dist: int = 50) -> Tuple[int, int]:
    """Greedy shift search: (number of shifts, final edit distance). Each round tries every span of the
    hypothesis that occurs in the reference at every other position and keeps the best; at most 20 rounds."""
    shifts = 0
    current = list(pred)
    best_dist = _edit_distance(current, ref)
    ref_set = {tuple(ref[i : i + L]) for L in range(1, max_shift_size + 1) for i in range(len(ref) - L + 1)}
    for _ in range(20):
        best_candidate = None
        best_candidate_dist = best_dist
        n = len(current)
        for start in range(n):
            for length in range(1, min(max_shift_size, n - start) + 1):
                span = tuple(current[start : start + length])
                if span not in ref_set:
                    continue
                rest = current[:start] + current[start + length :]
                for pos in range(len(rest) + 1):
                    if pos == start:
                        continue
                    cand = rest[:pos] + list(span) + rest[pos:]
                    d = _edit_distance(cand, ref)
                    if d < best_candidate_dist:
                        best_candidate_dist = d
                        best_candidate = cand
        if best_candidate is not None and best_candidate_dist < best_dist:
            current = best_candidate
            best_dist = best_candidate_dist
            shifts += 1
        else:
            break
    return shifts, best_dist


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    *,
    device: _Device = None,
):
    """Translation edit rate: the fewest shifts and edits to the closest reference, over the mean reference
    length.

    >>> preds = ['the cat is on the mat']
    >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
    >>> round(float(translation_edit_rate(preds, target, device="cpu")), 4)
    0.1538
    """
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    total_edits = 0.0
    total_ref_len = 0.0
    sentence_scores = []
    for pred, refs in zip(preds_, target_):
        p_tok = _ter_preprocess(pred, lowercase, no_punctuation, asian_support, normalize)
        ref_toks = [_ter_preprocess(r, lowercase, no_punctuation, asian_support, normalize) for r in refs]
        best_edits = min(sum(_ter_shifts(p_tok, r_tok)) for r_tok in ref_toks)
        avg_len = float(np.mean([len(r) for r in ref_toks]))
        total_edits += best_edits
        total_ref_len += avg_len
        sentence_scores.append(best_edits / avg_len if avg_len else 0.0)
    score = total_edits / total_ref_len if total_ref_len else 0.0
    return _with_sentences(score, sentence_scores, return_sentence_level_score, device)


# --------------------------------------------------------------------------- extended edit distance
def _eed_preprocess_en(sentence: str) -> str:
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    sentence = re.sub(r"\s+", " ", sentence)
    sentence = re.sub(r"(\d) ([.,]) (\d)", r"\1\2\3", sentence)
    sentence = re.sub(r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1.", sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _eed_preprocess_ja(sentence: str) -> str:
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_single(hyp: str, ref: str, alpha: float, rho: float, deletion: float, insertion: float) -> float:
    """EED of one hypothesis and reference: the CDER grid DP with long jumps at the reference's blanks and the
    coverage penalty (Stanchev et al. 2019)."""
    lh = len(hyp)
    visits = np.full(lh + 1, -1, dtype=np.int64)
    row = np.ones(lh + 1)
    row[0] = 0.0
    for w in range(1, len(ref) + 1):
        next_row = np.empty(lh + 1)
        next_row[0] = row[0] + 1.0
        for i in range(1, lh + 1):
            sub = row[i - 1] + (0.0 if hyp[i - 1] == ref[w - 1] else 1.0)
            next_row[i] = min(next_row[i - 1] + deletion, sub, row[i] + insertion)
        min_index = int(np.argmin(next_row))
        visits[min_index] += 1
        if ref[w - 1] == " ":
            jump = alpha + next_row[min_index]
            next_row = np.minimum(next_row, jump)
        row = next_row
    coverage = rho * float(np.where(visits >= 0, visits, 1).sum())
    return min(1.0, (row[-1] + coverage) / (len(ref) + coverage))


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    *,
    device: _Device = None,
):
    """Extended edit distance, the mean over sentences of each one's best reference.

    >>> preds = ["this is the prediction", "here is an other sample"]
    >>> target = ["this is the reference", "here is another one"]
    >>> round(float(extended_edit_distance(preds, target, device="cpu")), 4)
    0.3078
    """
    if language not in ("en", "ja"):
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    preprocess = _eed_preprocess_en if language == "en" else _eed_preprocess_ja
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    scores = []
    for pred, refs in zip(preds_, target_):
        hyp = preprocess(pred)
        scores.append(min(_eed_single(hyp, preprocess(r), alpha, rho, deletion, insertion) for r in refs))
    avg = float(np.mean(scores)) if scores else 0.0
    return _with_sentences(avg, scores, return_sentence_level_score, device)
