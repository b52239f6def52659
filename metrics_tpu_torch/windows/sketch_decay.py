"""Time-decayed sketches by bucket-count and register rescale (counterpart of ``metrics_tpu/windows/sketch_decay.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from metrics_tpu_torch.functional.sketches.ddsketch import ddsketch_delta, ddsketch_quantiles
from metrics_tpu_torch.functional.sketches.hll import hll_delta
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.decay import _decay_fold, _decay_weights_compiled, decay_weights, decayed_hll_estimate
from metrics_tpu_torch.sketches.quantile import _check_config

__all__ = ["DecayedDDSketch", "DecayedHLL"]


def _require_positive_half_life(half_life_s: float) -> float:
    if not float(half_life_s) > 0.0:
        raise ValueError(f"`half_life_s` must be > 0, got {half_life_s}")
    return float(half_life_s)


class DecayedDDSketch(Metric):
    """Time-decayed streaming quantiles: a DDSketch whose counts forget.

    The bucket geometry of :class:`~metrics_tpu_torch.sketches.DDSketch`, with
    float32 counts that every update first rescales by
    ``2^(-Δt/half_life_s)``: ``compute()`` estimates the quantiles of the
    recency-weighted distribution. The state is the per-bucket decayed sum,
    order-invariant, so replicas merge by decaying both sides to a common
    reference time and adding.

    ``update(t, value)`` prepends a timestamp (nonnegative seconds, float32).

    Args: as :class:`~metrics_tpu_torch.sketches.DDSketch`, with ``half_life_s`` first.
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        half_life_s: float,
        alpha: float = 0.01,
        quantiles: Sequence[float] = (0.5, 0.9, 0.99),
        num_buckets: int = 2048,
        key_offset: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.quantiles = _check_config(alpha, quantiles, num_buckets)
        self.half_life_s = _require_positive_half_life(half_life_s)
        self.alpha = float(alpha)
        self.num_buckets = int(num_buckets)
        self.key_offset = int(-num_buckets // 2 if key_offset is None else key_offset)
        # float32 by contract: the decay bounds each bucket's mass by about rate * half_life / ln 2
        decay_contract = {"horizon": "decay-bounded", "note": "mass <= update_rate * half_life / ln(2)"}
        for name, shape in (("pos_buckets", (self.num_buckets,)), ("neg_buckets", (self.num_buckets,)),
                            ("zero_count", ())):
            self.add_state(name, default=torch.zeros(shape, dtype=torch.float32), dist_reduce_fx="sum",
                           precision=decay_contract)
        self.add_state("last_t", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="max")

    def update(self, t: Any, value: torch.Tensor) -> None:
        value = torch.as_tensor(value, device=self.device)
        d_pos, d_neg, d_zero = ddsketch_delta(
            value,
            torch.ones(value.shape, dtype=torch.bool, device=self.device),
            alpha=self.alpha,
            key_offset=self.key_offset,
            num_buckets=self.num_buckets,
        )
        ref, w_old, w_new = _decay_weights_compiled(self.last_t, t, self.half_life_s)
        self.pos_buckets = _decay_fold(self.pos_buckets, w_old, d_pos.to(torch.float32) * w_new)
        self.neg_buckets = _decay_fold(self.neg_buckets, w_old, d_neg.to(torch.float32) * w_new)
        self.zero_count = _decay_fold(self.zero_count, w_old, d_zero.to(torch.float32) * w_new)
        self.last_t = ref

    def compute(self) -> torch.Tensor:
        return ddsketch_quantiles(
            self.pos_buckets, self.neg_buckets, self.zero_count, self.quantiles,
            alpha=self.alpha, key_offset=self.key_offset,
        )

    def _merge_state_dicts(
        self, state_a: Dict[str, Any], state_b: Dict[str, Any], count_a: int, count_b: int
    ) -> Dict[str, Any]:
        ref, w_a, w_b = decay_weights(state_a["last_t"], state_b["last_t"], self.half_life_s)
        out = {name: state_a[name] * w_a + state_b[name] * w_b for name in ("pos_buckets", "neg_buckets", "zero_count")}
        out["last_t"] = ref
        return out


class DecayedHLL(Metric):
    """Time-decayed distinct count: HyperLogLog registers that forget.

    Registers are float32 decaying-max ranks, ``regs = max(regs·w_old,
    delta·w_new)``; the rescale distributes over ``max``, so the state is
    ``max_i rank_i·2^(-(ref-t_i)/half_life)``, order-invariant, and replicas
    merge by decaying both to a common reference time and taking the maximum.
    ``compute()`` treats a register decayed below rank ½ as empty.

    ``update(t, values)`` prepends a timestamp (nonnegative seconds, float32).

    Args: as :class:`~metrics_tpu_torch.sketches.HyperLogLog`, with ``half_life_s`` first. ``p`` is accepted
        in [4, 18] as in the JAX package, whose update refuses ``p > 16`` all the same.
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, half_life_s: float, p: int = 12, seed: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not 4 <= int(p) <= 18:
            raise ValueError(f"`p` must be in [4, 18], got {p}")
        self.half_life_s = _require_positive_half_life(half_life_s)
        self.p = int(p)
        self.seed = int(seed)
        self.add_state("registers", default=torch.zeros(1 << self.p, dtype=torch.float32), dist_reduce_fx="max")
        self.add_state("last_t", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="max")

    def update(self, t: Any, values: torch.Tensor) -> None:
        values = torch.as_tensor(values, device=self.device)
        delta = hll_delta(values, torch.ones(values.shape, dtype=torch.bool, device=self.device), p=self.p,
                          seed=self.seed)
        ref, w_old, w_new = _decay_weights_compiled(self.last_t, t, self.half_life_s)
        self.registers = torch.maximum(self.registers * w_old, delta.to(torch.float32) * w_new)
        self.last_t = ref

    def compute(self) -> torch.Tensor:
        return decayed_hll_estimate(self.registers)

    def _merge_state_dicts(
        self, state_a: Dict[str, Any], state_b: Dict[str, Any], count_a: int, count_b: int
    ) -> Dict[str, Any]:
        ref, w_a, w_b = decay_weights(state_a["last_t"], state_b["last_t"], self.half_life_s)
        return {"registers": torch.maximum(state_a["registers"] * w_a, state_b["registers"] * w_b), "last_t": ref}
