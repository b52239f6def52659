"""Functional text metrics (counterpart of ``metrics_tpu/functional/text``): every function but the two that
need a pretrained model (``bert_score``, ``infolm``). Strings are tokenized and compared on the host; each
function takes a keyword-only ``device`` for its result ("cuda" when omitted), and ``perplexity`` computes on
its logits' device."""

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

__all__ = [
    "bleu_score",
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
