"""Modular text metrics (counterpart of ``metrics_tpu/text``); ``BERTScore`` and ``InfoLM`` take an injected
encoder or distribution function."""

from metrics_tpu_torch.text.metrics import (
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    EditDistance,
    ExtendedEditDistance,
    MatchErrorRate,
    Perplexity,
    ROUGEScore,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from metrics_tpu_torch.text.model_based import BERTScore, InfoLM


__all__ = [
    "BERTScore",
    "BLEUScore",
    "CHRFScore",
    "CharErrorRate",
    "EditDistance",
    "ExtendedEditDistance",
    "InfoLM",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SQuAD",
    "SacreBLEUScore",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
