"""Functional text metrics (counterpart of ``metrics_tpu/functional/text``). Strings are tokenized and
compared on the host; each function takes a keyword-only ``device`` for its result ("cuda" when omitted),
``perplexity`` computes on its logits' device, and ``bert_score``/``infolm`` take ``device=`` with the other
``Metric`` keywords."""

from metrics_tpu_torch.functional.text.bleu import bleu_score, sacre_bleu_score
from metrics_tpu_torch.functional.text.chrf import chrf_score
from metrics_tpu_torch.functional.text.error_rates import (
    char_error_rate,
    edit_distance,
    match_error_rate,
    word_error_rate,
    word_information_lost,
    word_information_preserved,
)
from metrics_tpu_torch.functional.text.misc import extended_edit_distance, squad, translation_edit_rate
from metrics_tpu_torch.functional.text.perplexity import perplexity
from metrics_tpu_torch.functional.text.rouge import rouge_score
from metrics_tpu_torch.functional.text.model_based import bert_score, infolm


__all__ = [
    "bert_score",
    "bleu_score",
    "infolm",
    "char_error_rate",
    "chrf_score",
    "edit_distance",
    "extended_edit_distance",
    "match_error_rate",
    "perplexity",
    "rouge_score",
    "sacre_bleu_score",
    "squad",
    "translation_edit_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
