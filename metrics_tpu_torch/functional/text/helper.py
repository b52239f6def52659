"""Text-metric helpers on the host (counterpart of ``metrics_tpu/functional/text/helper.py``): the
edit-distance DP and its operation counts, the tokenizers and the n-gram counts.

Strings are host data: tokenizing and the dynamic programs run in Python and
numpy, as in the JAX package, and only the resulting counts become tensor
states. The algorithms are copied step for step, so the counts are equal; in
particular the backtrack of :func:`_edit_distance_counts` prefers the diagonal,
then the insertion, which decides how MER and WIL split hits and substitutions.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np


def _edit_distance(prediction_tokens: Sequence, reference_tokens: Sequence) -> int:
    """Levenshtein distance by numpy DP rows, each row's insertion chain resolved by a scan."""
    n = len(reference_tokens)
    prev = np.arange(n + 1)
    for i, p_tok in enumerate(prediction_tokens, start=1):
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + np.asarray([p_tok != r_tok for r_tok in reference_tokens])
        # cur[j] = min(prev[j]+1, cur[j-1]+1, sub[j-1])
        best = np.minimum(prev[1:] + 1, sub)
        cur_j = cur[0]
        for j in range(1, n + 1):
            cur_j = min(best[j - 1], cur_j + 1)
            cur[j] = cur_j
        prev = cur
    return int(prev[-1])


def _edit_distance_counts(pred_tokens: Sequence, ref_tokens: Sequence) -> Tuple[int, int, int, int]:
    """(substitutions, deletions, insertions, hits) from the full DP table and one backtrack."""
    m, n = len(pred_tokens), len(ref_tokens)
    dp = np.zeros((m + 1, n + 1), dtype=np.int64)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            cost = 0 if pred_tokens[i - 1] == ref_tokens[j - 1] else 1
            dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1, dp[i - 1, j - 1] + cost)
    i, j = m, n
    s = d = ins = h = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (0 if pred_tokens[i - 1] == ref_tokens[j - 1] else 1):
            if pred_tokens[i - 1] == ref_tokens[j - 1]:
                h += 1
            else:
                s += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            ins += 1
            i -= 1
        else:
            d += 1
            j -= 1
    return s, d, ins, h


def _tokenize_words(text: str) -> List[str]:
    return text.split()


def _tokenize_chars(text: str) -> List[str]:
    # every character space-joined and split again, so whitespace characters are no tokens
    return " ".join(text).split()


_13A_RE = [
    (re.compile(r"<skipped>"), ""),
    (re.compile(r"-\n"), ""),
    (re.compile(r"\n"), " "),
]
_13A_TOK = [
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


def _tokenize_13a(line: str) -> List[str]:
    """The mteval-13a tokenization of SacreBLEU's default tokenizer."""
    for pat, rep in _13A_RE:
        line = pat.sub(rep, line)
    line = f" {line} "
    for pat, rep in _13A_TOK:
        line = pat.sub(rep, line)
    return line.split()


# the CJK, fullwidth and symbol ranges of SacreBLEU's zh tokenizer; the two astral entries are written as the
# JAX package writes them ("\u20000" is "\u2000" followed by "0"), so both packages split the same characters
_UCODE_RANGES = (
    ("\u3400", "\u4db5"),
    ("\u4e00", "\u9fa5"),
    ("\u9fa6", "\u9fbb"),
    ("\uf900", "\ufa2d"),
    ("\ufa30", "\ufa6a"),
    ("\ufa70", "\ufad9"),
    ("\u20000", "\u2a6d6"),
    ("\u2f800", "\u2fa1d"),
    ("\uff00", "\uffef"),
    ("\u2e80", "\u2eff"),
    ("\u3000", "\u303f"),
    ("\u31c0", "\u31ef"),
    ("\u2f00", "\u2fdf"),
    ("\u2ff0", "\u2fff"),
    ("\u3100", "\u312f"),
    ("\u31a0", "\u31bf"),
    ("\ufe10", "\ufe1f"),
    ("\ufe30", "\ufe4f"),
    ("\u2600", "\u26ff"),
    ("\u2700", "\u27bf"),
    ("\u3200", "\u32ff"),
    ("\u3300", "\u33ff"),
)


def _is_chinese_char(uchar: str) -> bool:
    return any(start <= uchar <= end for start, end in _UCODE_RANGES)


def _tokenize_zh(line: str) -> List[str]:
    """SacreBLEU's ``zh``: every CJK character spaced out, then the mteval punctuation rules."""
    line = line.strip()
    pieces = []
    for char in line:
        pieces.append(f" {char} " if _is_chinese_char(char) else char)
    line = "".join(pieces)
    for pat, rep in _13A_TOK:
        line = pat.sub(rep, line)
    return line.split()


_INT_PATTERNS: List = []


def _tokenize_international(line: str) -> List[str]:
    r"""The mteval-v14 international tokenization: split at unicode punctuation (``\p{P}``) unless between
    digits, and at every unicode symbol (``\p{S}``). Needs the ``regex`` package."""
    if not _INT_PATTERNS:
        import regex

        _INT_PATTERNS.extend(
            (
                (regex.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
                (regex.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
                (regex.compile(r"(\p{S})"), r" \1 "),
            )
        )
    for pat, rep in _INT_PATTERNS:
        line = pat.sub(rep, line)
    return line.split()


def _ngram_counts(tokens: Sequence, max_n: int) -> Counter:
    """Counter over the n-grams of orders 1 to ``max_n``."""
    counts: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


_SQUAD_ARTICLES = re.compile(r"\b(a|an|the)\b")
_SQUAD_PUNCT = re.compile(r"[^\w\s]")


def _squad_normalize(text: str) -> str:
    """SQuAD's answer normalization: lower case, no punctuation, no articles, single spaces."""
    text = text.lower()
    text = _SQUAD_PUNCT.sub("", text)
    text = _SQUAD_ARTICLES.sub(" ", text)
    return " ".join(text.split())
