"""Model-based text metrics: BERTScore and InfoLM with injectable encoders (counterpart of
``metrics_tpu/text/model_based.py``).

The caller injects an ``encoder`` (a list of strings → one ``(T_i, D)`` token-embedding array or tensor per
text) for BERTScore, or a ``distribution_fn`` (a list of strings → one ``(T_i, V)`` token-distribution array
per text) for InfoLM; the metric owns the score math. The JAX package computes it in float64 numpy on the
host, pair by pair. Here it runs in float64 on the metric's device, over batches of pairs: the texts' tokens
are laid end to end, each pair's rows found by its offsets, and a batch is one pass of torch ops with token
masks (no loop over pairs). The scores are averaged in float64 and rounded once to float32.

The stored pairs are a host list, not a state: ``sync()`` carries none, as in the JAX package, so each rank
scores its own pairs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric

# float64 temporaries of one batch of pairs stay under this many bytes (1 GiB: 1.25 % of an 80 GB card)
_CHUNK_BYTES = 1 << 30
_EPS = 1e-12


def _flat_tokens(items: Sequence[Any], device: torch.device) -> Tuple[Tensor, Tensor]:
    """Every text's ``(T_i, F)`` rows laid end to end as one float64 ``(sum T_i, F)`` tensor on ``device``, and
    the row offsets ``(n + 1,)`` (int64, on the host). Host arrays are joined on the host and copied once."""
    ts = [x if isinstance(x, Tensor) else torch.from_numpy(np.asarray(x, dtype=np.float64)) for x in items]
    width = next((t.shape[-1] for t in ts if t.ndim == 2 and t.shape[0]), 0)
    ts = [t.reshape(-1, width) if t.numel() == 0 else t for t in ts]
    lengths = torch.tensor([t.shape[0] for t in ts], dtype=torch.int64)
    offsets = torch.zeros(len(ts) + 1, dtype=torch.int64)
    torch.cumsum(lengths, 0, out=offsets[1:])
    if not ts:
        return torch.zeros((0, width), dtype=torch.float64, device=device), offsets
    if all(t.device.type == "cpu" for t in ts):
        return torch.cat([t.to(torch.float64) for t in ts]).to(device), offsets
    return torch.cat([t.to(device, torch.float64) for t in ts]), offsets


def _rows(offsets: Tensor, a: int, b: int, device: torch.device) -> Tuple[Tensor, Tensor, Tensor]:
    """For the texts ``a..b``: each token row's text (0-based within the batch), its position in its text, and
    the batch's token counts, all on ``device``."""
    lengths = (offsets[a + 1:b + 1] - offsets[a:b]).to(device)
    text = torch.repeat_interleave(torch.arange(b - a, device=device), lengths)
    start = (offsets[a:b] - offsets[a]).to(device)
    pos = torch.arange(text.shape[0], device=device) - start[text]
    return text, pos, lengths


def _padded(flat: Tensor, offsets: Tensor, a: int, b: int) -> Tuple[Tensor, Tensor]:
    """Texts ``a..b`` as a zero-padded ``(b - a, T, F)`` batch and its ``(b - a, T)`` token mask."""
    text, pos, lengths = _rows(offsets, a, b, flat.device)
    width = int(lengths.max()) if lengths.numel() else 0
    out = flat.new_zeros((b - a, width, flat.shape[1]))
    out[text, pos] = flat[int(offsets[a]):int(offsets[b])]
    mask = torch.arange(width, device=flat.device) < lengths[:, None]
    return out, mask


def _batches(n: int, per_pair_bytes: int) -> List[Tuple[int, int]]:
    step = max(1, _CHUNK_BYTES // max(per_pair_bytes, 1))
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def _unit_rows(x: Tensor) -> Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(_EPS)


def _bert_pair_scores(pred_embs: Sequence[Any], tgt_embs: Sequence[Any], device: torch.device) -> Tensor:
    """``(n, 3)`` float64 precision, recall and F1 of each pair's greedy cosine matching."""
    pf, po = _flat_tokens(list(pred_embs), device)
    tf, to = _flat_tokens(list(tgt_embs), device)
    n = min(po.shape[0], to.shape[0]) - 1
    pf, tf = _unit_rows(pf), _unit_rows(tf)
    tp = int((po[1:] - po[:-1]).max()) if n else 0
    tt = int((to[1:] - to[:-1]).max()) if n else 0
    out = []
    for a, b in _batches(n, 8 * (tp * tt * 3 + (tp + tt) * max(pf.shape[1], 1))):
        pe, pm = _padded(pf, po, a, b)
        te, tm = _padded(tf, to, a, b)
        sim = torch.bmm(pe, te.transpose(1, 2))  # (B, Tp, Tt)
        pair = pm[:, :, None] & tm[:, None, :]
        sim = sim.masked_fill(~pair, -torch.inf)
        n_p, n_t = pm.sum(1), tm.sum(1)
        nonempty = (n_p > 0) & (n_t > 0)
        row = sim.amax(2).masked_fill(~pm, 0.0) if sim.shape[2] else sim.new_zeros(pm.shape)
        col = sim.amax(1).masked_fill(~tm, 0.0) if sim.shape[1] else sim.new_zeros(tm.shape)
        p = torch.where(nonempty, row.sum(1) / n_p.clamp_min(1), 0.0)
        r = torch.where(nonempty, col.sum(1) / n_t.clamp_min(1), 0.0)
        s = p + r
        f = torch.where(s != 0, 2 * p * r / torch.where(s != 0, s, 1.0), 0.0)
        out.append(torch.stack([p, r, f], dim=1))
    return torch.cat(out) if out else torch.zeros((0, 3), dtype=torch.float64, device=device)


class BERTScore(Metric):
    """BERTScore: greedy cosine matching of token embeddings.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> vocab = {w: rng.rand(8) for w in "the cat sat on mat a dog ran".split()}
    >>> encoder = lambda texts: [np.stack([vocab[w] for w in t.split()]) for t in texts]
    >>> metric = BERTScore(encoder=encoder, device="cpu")
    >>> metric.update(["the cat sat"], ["the cat sat"])
    >>> round(float(metric.compute()["f1"]), 4)
    1.0
    """

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        encoder: Optional[Callable] = None,
        idf: bool = False,
        rescale_with_baseline: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if encoder is None:
            # a local Hugging Face checkpoint (roberta-large by name); raises when none is on disk
            from metrics_tpu_torch.models.hub import load_text_encoder

            encoder = load_text_encoder(model_name_or_path or "roberta-large", device=self.device)
        self.encoder = encoder
        self.idf = idf
        self.rescale_with_baseline = rescale_with_baseline
        self._pairs: List = []

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        """Store prediction/reference pairs."""
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [target] if isinstance(target, str) else list(target)
        self._pairs.extend(zip(preds_, target_))

    def compute(self) -> Dict[str, Tensor]:
        """Greedy-match precision, recall and F1 per pair, averaged over pairs."""
        scores = _bert_pair_scores(
            self.encoder([p for p, _ in self._pairs]), self.encoder([t for _, t in self._pairs]), self.device)
        mean = (scores.mean(0) if scores.shape[0] else scores.new_zeros(3)).to(torch.float32)
        return {"precision": mean[0], "recall": mean[1], "f1": mean[2]}

    def reset(self) -> None:
        """Reset stored pairs too."""
        super().reset()
        self._pairs = []


def _measure(m: str, p: Tensor, q: Tensor, alpha: float, beta: float) -> Tensor:
    """The information measure ``m`` between the rows of ``p`` and ``q`` (each clipped at 1e-12)."""
    p, q = p.clamp_min(_EPS), q.clamp_min(_EPS)
    if m == "kl_divergence":
        return (p * torch.log(p / q)).sum(-1)
    if m == "l1_distance":
        return (p - q).abs().sum(-1)
    if m == "l2_distance":
        return torch.sqrt(((p - q) ** 2).sum(-1))
    if m == "l_infinity_distance":
        return (p - q).abs().amax(-1)
    if m == "fisher_rao_distance":
        return 2 * torch.arccos(torch.sqrt(p * q).sum(-1).clamp(0, 1))
    if m == "alpha_divergence":
        a = alpha
        return (1 - (p**a * q ** (1 - a)).sum(-1)) / (a * (1 - a))
    if m == "renyi_divergence":
        a = alpha
        return torch.log((p**a * q ** (1 - a)).sum(-1)) / (a - 1)
    if m == "beta_divergence":
        b = beta
        return (p ** (b + 1)).sum(-1) / (b * (b + 1)) + (q ** (b + 1)).sum(-1) / (b + 1) - (p * q**b).sum(-1) / b
    a, b = alpha, beta  # ab_divergence
    return (torch.log((p ** (a + b)).sum(-1)) / (b * (a + b)) + torch.log((q ** (a + b)).sum(-1)) / (a * (a + b))
            - torch.log((p**a * q**b).sum(-1)) / (a * b))


class InfoLM(Metric):
    """InfoLM: an information measure between the masked-LM token distributions of prediction and reference.

    Requires a ``distribution_fn`` mapping a list of strings to per-text token probability arrays (T_i, V),
    e.g. a masked-LM forward.
    """

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    _MEASURES = ("kl_divergence", "alpha_divergence", "beta_divergence", "ab_divergence",
                 "renyi_divergence", "l1_distance", "l2_distance", "l_infinity_distance",
                 "fisher_rao_distance")

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        distribution_fn: Optional[Callable] = None,
        information_measure: str = "kl_divergence",
        idf: bool = False,
        alpha: float = 0.25,
        beta: float = 0.25,
        temperature: float = 0.25,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if distribution_fn is None:
            raise ModuleNotFoundError(
                f"The pretrained checkpoint {model_name_or_path!r} requires downloaded transformers weights,"
                " unavailable offline. Pass `distribution_fn=` returning per-token distributions."
            )
        if information_measure not in self._MEASURES:
            raise ValueError(f"Expected `information_measure` to be one of {self._MEASURES}")
        if not (isinstance(temperature, (int, float)) and temperature > 0):
            raise ValueError(f"Expected `temperature` to be a positive number but got {temperature}")
        self.distribution_fn = distribution_fn
        self.information_measure = information_measure
        self.idf = idf
        self.alpha = alpha
        self.beta = beta
        # softmax(z / T) is softmax(z)^(1/T) renormalised, so p^(1/T) per token gives the temperature to
        # injected distributions; 1.0 leaves them untouched
        self.temperature = float(temperature)
        self._pairs: List = []

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        """Store prediction/reference pairs."""
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [target] if isinstance(target, str) else list(target)
        self._pairs.extend(zip(preds_, target_))

    def _pooled(self, dists: Sequence[Any], a: int, b: int) -> Tensor:
        """Texts ``a..b``'s tempered token distributions, averaged over tokens and renormalised: ``(b - a, V)``."""
        flat, offsets = _flat_tokens(list(dists[a:b]), self.device)
        if self.temperature != 1.0:  # ``flat`` is a fresh tensor: tempered in place
            flat = flat.clamp_min_(_EPS).pow_(1.0 / self.temperature)
            flat /= flat.sum(-1, keepdim=True)
        text, _, lengths = _rows(offsets, 0, b - a, self.device)
        pooled = flat.new_zeros((b - a, flat.shape[1])).index_add_(0, text, flat) / lengths[:, None]
        return pooled / pooled.sum(-1, keepdim=True)

    def _pair_scores(self) -> Tensor:
        """Each pair's score, float64 on the metric's device."""
        pred_dists = list(self.distribution_fn([p for p, _ in self._pairs]))
        tgt_dists = list(self.distribution_fn([t for _, t in self._pairs]))
        n = min(len(pred_dists), len(tgt_dists))
        if not n:
            return torch.zeros((0,), dtype=torch.float64, device=self.device)
        rows = max(int(np.shape(d)[0]) for d in pred_dists[:n] + tgt_dists[:n])
        vocab = max(int(np.shape(d)[-1]) for d in pred_dists[:n] + tgt_dists[:n])
        out = []
        for a, b in _batches(n, 8 * vocab * (2 * rows + 6)):
            p, q = self._pooled(pred_dists, a, b), self._pooled(tgt_dists, a, b)
            out.append(_measure(self.information_measure, p, q, self.alpha, self.beta))
        return torch.cat(out)

    def compute(self) -> Tensor:
        """The information measure averaged over pairs (of the mean-pooled token distributions)."""
        vals = self._pair_scores()
        return (vals.mean() if vals.numel() else vals.new_zeros(())).to(torch.float32)

    def compute_sentence_scores(self) -> Tensor:
        """Per-pair scores (the payload of ``infolm(..., return_sentence_level_score=True)``)."""
        return self._pair_scores().to(torch.float32)

    def reset(self) -> None:
        """Reset stored pairs too."""
        super().reset()
        self._pairs = []
