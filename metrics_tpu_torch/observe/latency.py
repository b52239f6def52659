"""Per-(phase, label) latency histograms backed by host-side DDSketch (counterpart of
``metrics_tpu/observe/latency.py``).

Every flight-recorder span (:mod:`metrics_tpu_torch.observe.tracing`) folds its
duration into a :class:`HostDDSketch` keyed ``(phase, label)`` on the
process-wide recorder. The sketch is a numpy twin of the device DDSketch
(:mod:`metrics_tpu_torch.functional.sketches.ddsketch`): identical γ/key-offset
bucketing, identical quantile read-out, so host telemetry and device-side
sketch metrics share one error model — relative error ≤ α per quantile, fixed
memory per sketch, and merge = elementwise ``+``.

That mergeability is the point: :func:`sync_telemetry` hierarchically merges
exported host sketches (this process + any peers) into fleet-wide quantiles
the same way metric state merges under its declared algebras — no raw event
shipping.

Defaults are tuned for host phase latencies: α = 0.02 (2 % relative error),
key window covering ~[30 ns, 2000 s], ~12 KB per (phase, label) pair.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from metrics_tpu_torch.observe import recorder as _recorder

__all__ = [
    "DEFAULT_ALPHA",
    "DEFAULT_KEY_OFFSET",
    "DEFAULT_NUM_BUCKETS",
    "HostDDSketch",
    "SUMMARY_QUANTILES",
    "export_state",
    "merge_latency_states",
    "observe_duration",
    "snapshot_latency",
    "summarize",
    "sync_telemetry",
]

DEFAULT_ALPHA = 0.02
# ceil(log_γ 30e-9) ≈ -437, ceil(log_γ 2000) ≈ 190 with γ ≈ 1.0408: window
# [key_offset, key_offset + num_buckets) = [-440, 200) covers both with slack
DEFAULT_KEY_OFFSET = -440
DEFAULT_NUM_BUCKETS = 640

SUMMARY_QUANTILES: Tuple[float, ...] = (0.5, 0.9, 0.99, 0.999)


class HostDDSketch:
    """Fixed-window DDSketch over host floats; numpy twin of ``ddsketch_delta``.

    Counts are int64 (a host sketch can absorb billions of spans), and exact
    ``count``/``sum``/``min``/``max`` ride along — all five pieces merge by
    the obvious algebra, so sketches from many hosts collapse losslessly into
    one (bucket counts add exactly; only the quantile *read-out* carries the
    ≤ α relative error).
    """

    __slots__ = (
        "alpha", "gamma", "_ln_gamma", "key_offset", "num_buckets",
        "pos", "neg", "zero", "count", "sum", "min", "max",
    )

    def __init__(
        self,
        alpha: float = DEFAULT_ALPHA,
        key_offset: int = DEFAULT_KEY_OFFSET,
        num_buckets: int = DEFAULT_NUM_BUCKETS,
    ) -> None:
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"`alpha` must be in (0, 1), got {alpha}")
        if num_buckets < 1:
            raise ValueError(f"`num_buckets` must be >= 1, got {num_buckets}")
        self.alpha = float(alpha)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._ln_gamma = math.log(self.gamma)
        self.key_offset = int(key_offset)
        self.num_buckets = int(num_buckets)
        self.pos = np.zeros(num_buckets, dtype=np.int64)
        self.neg = np.zeros(num_buckets, dtype=np.int64)
        self.zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -------------------------------------------------------------- ingest
    def observe(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            return
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v == 0.0:
            self.zero += 1
            return
        key = math.ceil(math.log(abs(v)) / self._ln_gamma)
        idx = key - self.key_offset
        if idx < 0:
            idx = 0
        elif idx >= self.num_buckets:
            idx = self.num_buckets - 1
        if v > 0.0:
            self.pos[idx] += 1
        else:
            self.neg[idx] += 1

    # --------------------------------------------------------------- merge
    def _check_compatible(self, other: "HostDDSketch") -> None:
        if (self.alpha, self.key_offset, self.num_buckets) != (
            other.alpha, other.key_offset, other.num_buckets,
        ):
            raise ValueError(
                "cannot merge incompatible sketches: "
                f"(alpha={self.alpha}, key_offset={self.key_offset}, num_buckets={self.num_buckets}) vs "
                f"(alpha={other.alpha}, key_offset={other.key_offset}, num_buckets={other.num_buckets})"
            )

    def merge(self, other: "HostDDSketch") -> "HostDDSketch":
        """In-place merge; afterwards ``self`` describes the combined stream."""
        self._check_compatible(other)
        self.pos += other.pos
        self.neg += other.neg
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def copy(self) -> "HostDDSketch":
        out = HostDDSketch(self.alpha, self.key_offset, self.num_buckets)
        out.pos = self.pos.copy()
        out.neg = self.neg.copy()
        out.zero = self.zero
        out.count = self.count
        out.sum = self.sum
        out.min = self.min
        out.max = self.max
        return out

    # ------------------------------------------------------------- readout
    def quantiles(self, qs: Sequence[float]) -> np.ndarray:
        """Quantile estimates; the numpy mirror of ``ddsketch_quantiles``."""
        keys = np.arange(self.num_buckets, dtype=np.float64) + float(self.key_offset)
        rep = 2.0 * np.exp(keys * self._ln_gamma) / (self.gamma + 1.0)
        line = np.concatenate([-rep[::-1], np.zeros(1), rep])
        counts = np.concatenate([self.neg[::-1], [self.zero], self.pos]).astype(np.float64)
        cum = np.cumsum(counts)
        n = cum[-1]
        rank = np.asarray(qs, dtype=np.float64) * max(n - 1.0, 0.0)
        bucket = np.searchsorted(cum, rank, side="right")
        out = line[np.clip(bucket, 0, line.shape[0] - 1)]
        return np.where(n > 0, out, 0.0)

    def quantile(self, q: float) -> float:
        return float(self.quantiles([q])[0])

    # --------------------------------------------------------------- state
    def state(self) -> Dict[str, Any]:
        """JSON-able mergeable state (what :func:`export_state` ships)."""
        return {
            "alpha": self.alpha,
            "key_offset": self.key_offset,
            "num_buckets": self.num_buckets,
            "pos": self.pos.tolist(),
            "neg": self.neg.tolist(),
            "zero": int(self.zero),
            "count": int(self.count),
            "sum": float(self.sum),
            "min": None if self.count == 0 else float(self.min),
            "max": None if self.count == 0 else float(self.max),
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "HostDDSketch":
        out = cls(state["alpha"], state["key_offset"], state["num_buckets"])
        out.pos = np.asarray(state["pos"], dtype=np.int64)
        out.neg = np.asarray(state["neg"], dtype=np.int64)
        out.zero = int(state["zero"])
        out.count = int(state["count"])
        out.sum = float(state["sum"])
        out.min = math.inf if state["min"] is None else float(state["min"])
        out.max = -math.inf if state["max"] is None else float(state["max"])
        return out


# ---------------------------------------------------------------- recorder glue
def observe_duration(phase: str, label: str, seconds: float) -> None:
    """Fold one duration into the recorder's (phase, label) sketch.

    Called by the span machinery only while telemetry is enabled; the sketch
    dict lives on the Recorder so ``reset()``/``scope()`` clear it with
    everything else.
    """
    rec = _recorder.RECORDER
    key = (phase, label)
    with rec._lock:
        sk = rec.latency.get(key)
        if sk is None:
            sk = rec.latency[key] = HostDDSketch()
        sk.observe(seconds)


def summarize(sk: HostDDSketch, quantiles: Sequence[float] = SUMMARY_QUANTILES) -> Dict[str, Any]:
    """One sketch as a JSON-able summary: exact count/mean/min/max + quantiles."""
    out: Dict[str, Any] = {
        "count": int(sk.count),
        "total_s": float(sk.sum),
        "mean_s": float(sk.sum / sk.count) if sk.count else 0.0,
        "min_s": float(sk.min) if sk.count else 0.0,
        "max_s": float(sk.max) if sk.count else 0.0,
    }
    qs = sk.quantiles(quantiles)
    for q, v in zip(quantiles, qs):
        out[_quantile_key(q)] = float(v)
    return out


def _quantile_key(q: float) -> str:
    """0.5 -> "p50_s", 0.9 -> "p90_s", 0.99 -> "p99_s", 0.999 -> "p999_s"."""
    digits = f"{q:g}".split(".", 1)[1] if "." in f"{q:g}" else "0"
    if len(digits) == 1:
        digits += "0"
    return f"p{digits}_s"


def snapshot_latency(quantiles: Sequence[float] = SUMMARY_QUANTILES) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """All recorder sketches summarized as ``{phase: {label: summary}}``.

    Caller must NOT hold the recorder lock (this takes it to copy the dict).
    """
    rec = _recorder.RECORDER
    with rec._lock:
        sketches = {key: sk.copy() for key, sk in rec.latency.items()}
    out: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for (phase, label), sk in sorted(sketches.items()):
        out.setdefault(phase, {})[label] = summarize(sk, quantiles)
    return out


# ------------------------------------------------------------- fleet aggregation
def export_state() -> Dict[str, Dict[str, Dict[str, Any]]]:
    """This process's sketches as JSON-able mergeable state ``{phase: {label: state}}``."""
    rec = _recorder.RECORDER
    with rec._lock:
        sketches = {key: sk.copy() for key, sk in rec.latency.items()}
    out: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for (phase, label), sk in sketches.items():
        out.setdefault(phase, {})[label] = sk.state()
    return out


def merge_latency_states(
    states: Iterable[Dict[str, Dict[str, Dict[str, Any]]]],
) -> Dict[Tuple[str, str], HostDDSketch]:
    """Merge exported states from many hosts into one sketch per (phase, label).

    Phases/labels present on only some hosts merge fine (absent = empty
    sketch); incompatible sketch geometry raises.
    """
    merged: Dict[Tuple[str, str], HostDDSketch] = {}
    for state in states:
        for phase, by_label in state.items():
            for label, sk_state in by_label.items():
                sk = HostDDSketch.from_state(sk_state)
                prior = merged.get((phase, label))
                if prior is None:
                    merged[(phase, label)] = sk
                else:
                    prior.merge(sk)
    return merged


def sync_telemetry(
    peer_states: Optional[Iterable[Dict[str, Dict[str, Dict[str, Any]]]]] = None,
    quantiles: Sequence[float] = SUMMARY_QUANTILES,
) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Fleet-wide latency quantiles: local sketches merged with peers'.

    ``peer_states`` is an iterable of :func:`export_state` payloads from other
    hosts (any transport — an RPC layer, a shared filesystem, or a
    ``torch.distributed`` object broadcast of the JSON). Merging is hierarchical and associative: a rack
    aggregator may merge its hosts and forward one payload upward; quantiles
    of the merged sketch match a sketch that saw every host's stream (bucket
    counts add exactly).
    """
    states: List[Dict[str, Dict[str, Dict[str, Any]]]] = [export_state()]
    if peer_states is not None:
        states.extend(peer_states)
    merged = merge_latency_states(states)
    out: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for (phase, label), sk in sorted(merged.items()):
        out.setdefault(phase, {})[label] = summarize(sk, quantiles)
    return out
