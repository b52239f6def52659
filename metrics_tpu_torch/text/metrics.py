"""Modular text metrics (counterpart of ``metrics_tpu/text/metrics.py``).

Strings are processed on the host at each update, and the counts they give
become sum states on the metric's device. The states keep the JAX package's
types: the error, BLEU and chrF counts are float tensors of the default type
(``jnp.zeros(())``'s counterpart, float32 unless the caller made float64 the
default), exact below 2^24; ``EditDistance``'s and ``Perplexity``'s counts are
``count_dtype()`` (int64). ROUGE, TER, EED and SQuAD keep the raw strings
outside the state system (``_StringStoreMetric``) and score them at
``compute``: ``forward``, ``merge_state`` and ``reset`` carry the stores, and
a cross-rank ``sync()`` does not, so those four compute on the local rank's
strings only, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _get_tokenizer
from metrics_tpu_torch.functional.text.chrf import _chrf_counters, _validate_orders, chrf_score
from metrics_tpu_torch.functional.text.error_rates import (
    _cer_update,
    _mer_wil_update,
    _wer_update,
    _wip,
    edit_distance as _edit_distance_fn,
)
from metrics_tpu_torch.functional.text.helper import _tokenize_words
from metrics_tpu_torch.functional.text.misc import extended_edit_distance, squad, translation_edit_rate
from metrics_tpu_torch.functional.text.perplexity import _perplexity_compute, _perplexity_update
from metrics_tpu_torch.functional.text.rouge import rouge_score
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype
from metrics_tpu_torch.utils.data import dim_zero_cat


def _zero() -> Tensor:
    """A 0-d float state of the default type, as ``jnp.zeros(())`` is in the JAX package."""
    return torch.zeros(())


class _ErrorRateMetric(Metric):
    """Shared plumbing: the errors and total sum states of a host-side token DP."""

    __jit_ineligible__ = True  # string inputs are host data
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    errors: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", _zero(), dist_reduce_fx="sum")
        self.add_state("total", _zero(), dist_reduce_fx="sum")

    def _add(self, errors: int, total: int) -> None:
        self.errors = self.errors + float(errors)
        self.total = self.total + float(total)

    def compute(self) -> Tensor:
        """Compute metric."""
        return (self.errors / self.total).to(torch.float32)


class WordErrorRate(_ErrorRateMetric):
    """Word error rate.

    >>> preds = ["this is the prediction", "there is an other sample"]
    >>> target = ["this is the reference", "there is another one"]
    >>> wer = WordErrorRate(device="cpu")
    >>> wer.update(preds, target)
    >>> wer.compute()
    tensor(0.5000)
    """

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Update state with predictions and targets."""
        self._add(*_wer_update(preds, target))


class CharErrorRate(_ErrorRateMetric):
    """Character error rate."""

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Update state with predictions and targets."""
        self._add(*_cer_update(preds, target))


class MatchErrorRate(_ErrorRateMetric):
    """Match error rate."""

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Update state with predictions and targets."""
        self._add(*_mer_wil_update(preds, target)[:2])


class WordInfoPreserved(Metric):
    """Word information preserved."""

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("total_hits", _zero(), dist_reduce_fx="sum")
        self.add_state("target_total", _zero(), dist_reduce_fx="sum")
        self.add_state("preds_total", _zero(), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Update state with predictions and targets."""
        _, _, hits, target_total, preds_total = _mer_wil_update(preds, target)
        self.total_hits = self.total_hits + float(hits)
        self.target_total = self.target_total + float(target_total)
        self.preds_total = self.preds_total + float(preds_total)

    def compute(self) -> Tensor:
        """Compute metric."""
        return _wip(self.total_hits, self.target_total, self.preds_total).to(torch.float32)


class WordInfoLost(WordInfoPreserved):
    """Word information lost."""

    higher_is_better = False

    def compute(self) -> Tensor:
        """Compute metric."""
        return (1 - super().compute()).to(torch.float32)


class EditDistance(Metric):
    """Character edit distance, reduced over the pairs by ``reduction``.

    >>> metric = EditDistance(device="cpu")
    >>> metric.update(["rain"], ["shine"])
    >>> metric.compute()
    tensor(3.)
    """

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, substitution_cost: int = 1, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(substitution_cost, int) and substitution_cost >= 0):
            raise ValueError("Expected argument `substitution_cost` to be a positive integer")
        self.substitution_cost = substitution_cost
        if reduction not in ("mean", "sum", "none", None):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        if reduction in ("mean", "sum"):
            self.add_state("edit_scores_list", _zero(), dist_reduce_fx="sum")
            self.add_state("num_elements", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")
        else:
            self.add_state("edit_scores", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Update state with predictions and targets."""
        dists = _edit_distance_fn(preds, target, self.substitution_cost, reduction="none", device=self.device)
        if self.reduction in ("mean", "sum"):
            self.edit_scores_list = self.edit_scores_list + dists.sum()
            self.num_elements = self.num_elements + dists.shape[0]
        else:
            self.edit_scores.append(dists)

    def compute(self) -> Tensor:
        """Compute metric."""
        if self.reduction == "mean":
            return self.edit_scores_list / self.num_elements
        if self.reduction == "sum":
            return self.edit_scores_list
        return dim_zero_cat(self.edit_scores)


class Perplexity(Metric):
    """Perplexity of target tokens under logits, on the metric's device.

    >>> import numpy as np
    >>> rng = np.random.RandomState(22)
    >>> metric = Perplexity(device="cpu")
    >>> metric.update(torch.from_numpy(rng.rand(2, 8, 5).astype(np.float32) * 10),
    ...               torch.from_numpy(rng.randint(5, size=(2, 8))))
    >>> float(metric.compute()) > 1
    True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", _zero(), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with logits (batch, seq, vocab) and targets (batch, seq)."""
        total, count = _perplexity_update(preds, target, self.ignore_index)
        self.total_log_probs = self.total_log_probs + total
        self.count = self.count + count

    def compute(self) -> Tensor:
        """Compute metric."""
        return _perplexity_compute(self.total_log_probs, self.count)


def _corpus(preds, target) -> Tuple[List[str], List[List[str]]]:
    return [preds] if isinstance(preds, str) else list(preds), [[t] if isinstance(t, str) else list(t) for t in target]


class BLEUScore(Metric):
    """BLEU score of whitespace-tokenized sentences; the n-gram counts are summed on the host in float64 and
    rounded once a batch into the float states.

    >>> preds = ['the cat is on the mat']
    >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
    >>> bleu = BLEUScore(device="cpu")
    >>> bleu.update(preds, target)
    >>> bleu.compute()
    tensor(0.7598)
    """

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram
        self._tokenizer = _tokenize_words
        self.add_state("preds_len", _zero(), dist_reduce_fx="sum")
        self.add_state("target_len", _zero(), dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(n_gram), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        """Update state with predictions and reference corpora."""
        preds_, target_ = _corpus(preds, target)
        numerator, denominator, preds_len, target_len = _bleu_score_update(
            preds_, target_, np.zeros(self.n_gram), np.zeros(self.n_gram), 0.0, 0.0, self.n_gram, self._tokenizer
        )
        counts = torch.from_numpy(np.concatenate([numerator, denominator])).to(self.device, self.numerator.dtype)
        self.numerator = self.numerator + counts[: self.n_gram]
        self.denominator = self.denominator + counts[self.n_gram:]
        self.preds_len = self.preds_len + preds_len
        self.target_len = self.target_len + target_len

    def compute(self) -> Tensor:
        """Compute metric."""
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.weights, self.smooth
        )


class SacreBLEUScore(BLEUScore):
    """BLEU with one of SacreBLEU's tokenizers (``13a`` by default)."""

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        self._tokenizer = _get_tokenizer(tokenize)
        self.lowercase = lowercase

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        """Update state with predictions and reference corpora."""
        preds_, target_ = _corpus(preds, target)
        if self.lowercase:
            preds_ = [p.lower() for p in preds_]
            target_ = [[t.lower() for t in refs] for refs in target_]
        super().update(preds_, target_)


class CHRFScore(Metric):
    """chrF (``n_word_order=0``) or chrF++ score.

    >>> preds = ['the cat is on the mat']
    >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
    >>> chrf = CHRFScore(device="cpu")
    >>> chrf.update(preds, target)
    >>> round(float(chrf.compute()), 4)
    0.864
    """

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _validate_orders(n_char_order, n_word_order, beta)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        total = n_char_order + n_word_order
        self.add_state("matches", torch.zeros(total), dist_reduce_fx="sum")
        self.add_state("preds_totals", torch.zeros(total), dist_reduce_fx="sum")
        self.add_state("target_totals", torch.zeros(total), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        """Update state with predictions and reference corpora."""
        preds_, target_ = _corpus(preds, target)
        counts = _chrf_counters(preds_, target_, self.n_char_order, self.n_word_order, self.lowercase, self.whitespace)
        on = torch.from_numpy(np.stack(counts)).to(self.device, self.matches.dtype)
        self.matches = self.matches + on[0]
        self.preds_totals = self.preds_totals + on[1]
        self.target_totals = self.target_totals + on[2]
        if self.return_sentence_level_score:
            _, sentence = chrf_score(
                preds_, target_, self.n_char_order, self.n_word_order, self.beta, self.lowercase,
                self.whitespace, return_sentence_level_score=True, device=self.device,
            )
            self.sentence_chrf.append(sentence)

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        """Compute metric."""
        zero = torch.zeros((), dtype=self.matches.dtype, device=self.matches.device)
        p_vec = torch.where(self.preds_totals > 0, self.matches / torch.clamp(self.preds_totals, min=1), zero)
        r_vec = torch.where(self.target_totals > 0, self.matches / torch.clamp(self.target_totals, min=1), zero)
        b2 = self.beta**2
        denom = b2 * p_vec + r_vec
        f_vec = torch.where(denom > 0, (1 + b2) * p_vec * r_vec / torch.where(denom > 0, denom, zero + 1.0), zero)
        corpus = f_vec.mean().to(torch.float32)
        if self.return_sentence_level_score:
            return corpus, dim_zero_cat(self.sentence_chrf)
        return corpus


class _StringStoreMetric(Metric):
    """Shared plumbing for the text metrics that score the raw strings at ``compute``.

    The strings live in two host lists beside the (empty) state dict. ``forward``
    scores the batch on a fresh store and splices the histories back,
    ``merge_state`` puts the incoming strings first, ``reset`` empties both, and
    :func:`metrics_tpu_torch.interop.load_reference_state` takes them from the
    ``_preds_store`` and ``_target_store`` keys. ``sync()`` carries no strings.
    """

    __jit_ineligible__ = True
    is_differentiable = False
    full_state_update = False
    _host_stores = ("_preds_store", "_target_store")

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._preds_store: List = []
        self._target_store: List = []

    def update(self, preds, target) -> None:
        """Store inputs for compute."""
        self._preds_store.extend([preds] if isinstance(preds, str) else list(preds))
        if isinstance(target, str):
            self._target_store.append(target)
        else:
            self._target_store.extend(list(target))

    def forward(self, *args: Any, **kwargs: Any):
        """The batch's own value, with the batch kept for the running value.

        The batch is scored on fresh stores; on any failure both stores and the
        update count are left as they were, so a half-stored batch cannot
        misalign later computes.
        """
        prev_preds, prev_target = self._preds_store, self._target_store
        prev_count = self._update_count
        self._preds_store, self._target_store = [], []
        try:
            self.update(*args, **kwargs)
            batch_val = self.compute()
        except Exception:
            self._preds_store, self._target_store = prev_preds, prev_target
            self._update_count = prev_count
            self._computed = None
            raise
        self._preds_store = prev_preds + self._preds_store
        self._target_store = prev_target + self._target_store
        self._computed = None  # the running compute must not reuse the batch value
        return batch_val

    def merge_state(self, incoming_state) -> None:
        """Fold another metric's stores in, the incoming strings first (the base merge's order for "cat")."""
        if not isinstance(incoming_state, _StringStoreMetric):
            raise ValueError(
                f"Expected incoming state to be a {self.__class__.__name__} holding its string "
                f"stores but got {type(incoming_state)}"
            )
        in_preds = list(incoming_state._preds_store)
        in_target = list(incoming_state._target_store)
        super().merge_state(incoming_state)
        self._preds_store = in_preds + self._preds_store
        self._target_store = in_target + self._target_store
        self._computed = None

    def reset(self) -> None:
        """Reset the stored strings too."""
        super().reset()
        self._preds_store = []
        self._target_store = []


class ROUGEScore(_StringStoreMetric):
    """ROUGE-N, ROUGE-L and ROUGE-Lsum (the stemmer needs nltk).

    >>> rouge = ROUGEScore(device="cpu")
    >>> rouge.update("My name is John", "Is your name John")
    >>> sorted(rouge.compute())[:2]
    ['rouge1_fmeasure', 'rouge1_precision']
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, use_stemmer: bool = False, accumulate: str = "best",
                 rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.rouge_keys = rouge_keys
        self.accumulate = accumulate
        self.use_stemmer = use_stemmer

    def compute(self) -> Dict[str, Tensor]:
        """Compute metric."""
        return rouge_score(self._preds_store, self._target_store, self.accumulate, self.use_stemmer, self.rouge_keys,
                           device=self.device)


class TranslationEditRate(_StringStoreMetric):
    """Translation edit rate."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, normalize: bool = False, no_punctuation: bool = False, lowercase: bool = True,
                 asian_support: bool = False, return_sentence_level_score: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support
        self.return_sentence_level_score = return_sentence_level_score

    def compute(self):
        """Compute metric."""
        return translation_edit_rate(
            self._preds_store, self._target_store, self.normalize, self.no_punctuation, self.lowercase,
            self.asian_support, self.return_sentence_level_score, device=self.device,
        )


class ExtendedEditDistance(_StringStoreMetric):
    """Extended edit distance."""

    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, language: str = "en", return_sentence_level_score: bool = False, alpha: float = 2.0,
                 rho: float = 0.3, deletion: float = 0.2, insertion: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion

    def compute(self):
        """Compute metric."""
        return extended_edit_distance(
            self._preds_store, self._target_store, self.language, self.return_sentence_level_score,
            self.alpha, self.rho, self.deletion, self.insertion, device=self.device,
        )


class SQuAD(_StringStoreMetric):
    """SQuAD exact match and F1; the stores hold the question-answering dicts.

    >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
    >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
    >>> metric = SQuAD(device="cpu")
    >>> metric.update(preds, target)
    >>> {k: float(v) for k, v in sorted(metric.compute().items())}
    {'exact_match': 100.0, 'f1': 100.0}
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def update(self, preds, target) -> None:
        """Store the predictions and targets for compute."""
        self._preds_store.extend([preds] if isinstance(preds, dict) else list(preds))
        self._target_store.extend([target] if isinstance(target, dict) else list(target))

    def compute(self) -> Dict[str, Tensor]:
        """Compute metric."""
        return squad(self._preds_store, self._target_store, device=self.device)
