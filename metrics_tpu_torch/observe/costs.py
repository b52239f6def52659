"""Cost profiles of metric updates (counterpart of ``metrics_tpu/observe/costs.py``).

For every exported metric class in :data:`PROFILE_CASES` the harness runs one update of a fresh state,
``m._functional_update(m._fresh_state(), *batch)``, on the given device (after one uncounted warm-up update),
and reports its cost under the JAX package's keys, each with a torch meaning:

* ``flops``: what ``torch.utils.flop_counter.FlopCounterMode`` counts over the update (matrix products and
  convolutions; elementwise work counts zero), as ``observe.metering.program_cost`` counts;
* ``bytes_accessed``: the bytes of every aten op's tensor inputs and outputs in the update, counted under a
  ``TorchDispatchMode``. A kernel wrapper counts as one op (its ``torch.library`` custom op, on either device),
  and a copy between the host and the card is left out (on the CPU it is no op at all), so the count is the
  same on the CPU and on the card, and one baseline serves both;
* ``peak_memory_bytes``: only on a CUDA device, the caching allocator's peak during the update above what was
  allocated before it, plus the bytes of the state and the batch (the counterparts of XLA's argument, output
  and temporary sizes). As in the JAX package, the key is absent where there is no memory analysis;
* ``shareable``: whether the class has a hashable configuration key (``Metric._config_key``), so that
  config-equal instances share one engine program; ``donation_eligible``: the JAX package's rule on the port's
  attributes (``donate_states=`` when given, else no list state);
* ``compile_count``, ``cache_hits``, ``aot_cacheable`` and ``cold_start_compile_count``: what an eager update
  has, 0, 0, False and 0, reported under ``dynamic=True`` as the JAX package reports its probes' counts.

The cases, their order, sizes and seeded batches are the JAX package's. Run with
``python -m metrics_tpu_torch.observe.profile``; the baseline is ``metrics_tpu_torch/observe/perf_baseline.json``
(see :mod:`metrics_tpu_torch.observe.profile`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "PROFILE_CASES",
    "CostReport",
    "ProfileCase",
    "collect_cost_report",
    "profile_case",
]

# the JAX package's problem sizes
_N, _C = 64, 4
_IMG = (2, 3, 16, 16)

_COPIES = ("aten::_to_copy", "aten::copy_", "aten::_copy_from", "aten::_copy_from_and_resize")


@dataclasses.dataclass(frozen=True)
class ProfileCase:
    """One exported Metric class, its constructor (``ctor(device=...)``) and a deterministic batch source."""

    name: str  # exported class name — the baseline key
    ctor: Callable[..., Any]
    batch: Callable[[np.random.RandomState], Tuple[Any, ...]]


@dataclasses.dataclass
class CostReport:
    case: ProfileCase
    ok: bool
    cost: Dict[str, Any] = dataclasses.field(default_factory=dict)
    error: str = ""


def _rng(case: ProfileCase) -> np.random.RandomState:
    return np.random.RandomState(zlib.crc32(case.name.encode()) % (2**31))


def case_batch(case: ProfileCase, device: Union[str, torch.device]) -> Tuple[Any, ...]:
    """The case's seeded batch, its tensors on ``device``."""
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in case.batch(_rng(case)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of each op's tensor inputs and outputs, a copy between the host and the card left out."""

    def __init__(self) -> None:
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):  # noqa: ANN001
        out = func(*args, **(kwargs or {}))
        tensors = _tensors((args, kwargs)) + _tensors(out)
        if func.name() in _COPIES and len({t.device.type for t in tensors}) > 1:
            return out  # a host <-> card copy, which the CPU run does not make
        self.nbytes += sum(_nbytes(t) for t in tensors)
        return out


@contextlib.contextmanager
def _kernels_as_ops() -> Iterator[None]:
    """Kernel wrappers go through their custom ops on either device while costs are counted, so that a kernel
    counts as one op wherever it runs."""
    from metrics_tpu_torch.ops import ssim_window as _b2

    with _b2.through_custom_op():
        yield


def _state_bytes(state: Dict[str, Any]) -> int:
    return sum(_nbytes(t) for t in _tensors(state))


def _donation_eligible(m: Any) -> bool:
    if m._donate_opt is not None:
        return bool(m._donate_opt)
    return not m._has_list_state()


def _count(m: Any, args: Sequence[Any], device: torch.device, include_memory: bool) -> Dict[str, Any]:
    """FLOPs, bytes and (on a CUDA device) peak memory of one update of a fresh state, after one uncounted
    update: a first call builds per-device constants once (decay folds, thresholds, bin edges), so that the
    counted update is the steady one on either device whatever ran before it."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), _kernels_as_ops():
        m._functional_update(m._fresh_state(), *args)
    state = m._fresh_state()
    on_card = device.type == "cuda" and include_memory
    if on_card:
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad(), _kernels_as_ops(), FlopCounterMode(display=False) as flops, _ByteCounter() as nbytes:
        m._functional_update(state, *args)
    cost: Dict[str, Any] = {"flops": float(flops.get_total_flops()), "bytes_accessed": float(nbytes.nbytes)}
    if on_card:
        torch.cuda.synchronize(device)
        peak = max(0, torch.cuda.max_memory_allocated(device) - before)  # what the update allocated on top
        cost["peak_memory_bytes"] = int(peak + _state_bytes(state) + sum(_nbytes(t) for t in _tensors(args)))
    return cost


def profile_case(
    case: ProfileCase,
    include_memory: bool = True,
    dynamic: bool = True,
    device: Union[str, torch.device, None] = None,
) -> CostReport:
    """Count one class's update on ``device`` (the card unless named).

    ``dynamic=True`` also reports the compile, cache and cold-start keys, which for an eager update are
    constants. ``include_memory=False`` leaves out ``peak_memory_bytes``.
    """
    from metrics_tpu_torch.metric import Metric, resolve_device

    try:
        dev = resolve_device(device)
        m = case.ctor(device=dev)
        if not isinstance(m, Metric):
            return CostReport(case, ok=False, error=f"{case.name} did not construct a Metric")
        if type(m).__jit_ineligible__ or m._has_list_state():
            return CostReport(case, ok=False, error="not jit-eligible (list state or host-side update)")
        args = case_batch(case, dev)
        cost = _count(m, args, dev, include_memory)
        cost["shareable"] = m._config_key() is not None
        cost["donation_eligible"] = _donation_eligible(m)
        if dynamic:
            # an eager update compiles nothing and hits no cache, so a new process pays no compile either
            cost.update({"compile_count": 0, "cache_hits": 0, "aot_cacheable": False, "cold_start_compile_count": 0})
        return CostReport(case, ok=True, cost=cost)
    except Exception as exc:  # noqa: BLE001 — the error text IS the result
        return CostReport(case, ok=False, error=f"{type(exc).__name__}: {exc}")


def collect_cost_report(
    cases: Optional[Sequence[ProfileCase]] = None,
    include_memory: bool = True,
    dynamic: bool = True,
    device: Union[str, torch.device, None] = None,
) -> List[CostReport]:
    """Profile every case on ``device``; returns all results (callers apply the baseline)."""
    return [
        profile_case(c, include_memory=include_memory, dynamic=dynamic, device=device)
        for c in (cases if cases is not None else _cases())
    ]


# --------------------------------------------------------------------------- registry
def _rand(rng: np.random.RandomState, *shape: int) -> torch.Tensor:
    return torch.from_numpy(rng.rand(*shape).astype(np.float32))


def _randint(rng: np.random.RandomState, hi: int, *shape: int) -> torch.Tensor:
    return torch.from_numpy(rng.randint(0, hi, shape).astype(np.int32))


def _probs(rng: np.random.RandomState, *shape: int) -> torch.Tensor:
    p = rng.rand(*shape).astype(np.float32) + 0.05
    return torch.from_numpy(p / p.sum(-1, keepdims=True))


def _t(value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32)


def _make_cases() -> List[ProfileCase]:
    import metrics_tpu_torch as M
    import metrics_tpu_torch.classification as C
    import metrics_tpu_torch.segmentation as S

    def cls(c: Callable[..., Any], **kw: Any) -> Callable[..., Any]:
        return lambda device: c(device=device, **kw)

    case = ProfileCase
    bin_batch = lambda r: (_rand(r, _N), _randint(r, 2, _N))  # noqa: E731
    reg_batch = lambda r: (_rand(r, _N), _rand(r, _N))  # noqa: E731
    mc_batch = lambda r: (_probs(r, _N, _C), _randint(r, _C, _N))  # noqa: E731
    ml_batch = lambda r: (_rand(r, _N, _C), _randint(r, 2, _N, _C))  # noqa: E731
    img_batch = lambda r: (_rand(r, *_IMG), _rand(r, *_IMG))  # noqa: E731
    seg_batch = lambda r: (_randint(r, _C, 2, 8, 8), _randint(r, _C, 2, 8, 8))  # noqa: E731
    nom_batch = lambda r: (_randint(r, _C, _N), _randint(r, _C, _N))  # noqa: E731
    sig_batch = lambda r: (_rand(r, 2, 256), _rand(r, 2, 256))  # noqa: E731

    return [
        # ---- classification (binary) ------------------------------------------
        case("BinaryAccuracy", cls(C.BinaryAccuracy), bin_batch),
        case("BinaryPrecision", cls(C.BinaryPrecision), bin_batch),
        case("BinaryRecall", cls(C.BinaryRecall), bin_batch),
        case("BinaryF1Score", cls(C.BinaryF1Score), bin_batch),
        case("BinarySpecificity", cls(C.BinarySpecificity), bin_batch),
        case("BinaryStatScores", cls(C.BinaryStatScores), bin_batch),
        case("BinaryHammingDistance", cls(C.BinaryHammingDistance), bin_batch),
        case("BinaryCohenKappa", cls(C.BinaryCohenKappa), bin_batch),
        case("BinaryMatthewsCorrCoef", cls(C.BinaryMatthewsCorrCoef), bin_batch),
        case("BinaryJaccardIndex", cls(C.BinaryJaccardIndex), bin_batch),
        case("BinaryHingeLoss", cls(C.BinaryHingeLoss), bin_batch),
        case("BinaryCalibrationError", cls(C.BinaryCalibrationError), bin_batch),
        case("BinaryAUROC", cls(C.BinaryAUROC, thresholds=16), bin_batch),
        case("BinaryAveragePrecision", cls(C.BinaryAveragePrecision, thresholds=16), bin_batch),
        case("BinaryNegativePredictiveValue", cls(C.BinaryNegativePredictiveValue), bin_batch),
        # ---- classification (multiclass / multilabel) -------------------------
        case("MulticlassAccuracy", cls(C.MulticlassAccuracy, num_classes=_C), mc_batch),
        case("MulticlassPrecision", cls(C.MulticlassPrecision, num_classes=_C), mc_batch),
        case("MulticlassRecall", cls(C.MulticlassRecall, num_classes=_C), mc_batch),
        case("MulticlassF1Score", cls(C.MulticlassF1Score, num_classes=_C), mc_batch),
        case("MulticlassConfusionMatrix", cls(C.MulticlassConfusionMatrix, num_classes=_C), mc_batch),
        case("MulticlassCohenKappa", cls(C.MulticlassCohenKappa, num_classes=_C), mc_batch),
        case("MulticlassAUROC", cls(C.MulticlassAUROC, num_classes=_C, thresholds=16), mc_batch),
        case("MulticlassExactMatch", cls(C.MulticlassExactMatch, num_classes=_C),
             lambda r: (_randint(r, _C, 8, 6), _randint(r, _C, 8, 6))),
        case("MultilabelFBetaScore", cls(C.MultilabelFBetaScore, beta=2.0, num_labels=_C), ml_batch),
        case("MultilabelAccuracy", cls(C.MultilabelAccuracy, num_labels=_C), ml_batch),
        # ---- regression --------------------------------------------------------
        case("MeanSquaredError", cls(M.MeanSquaredError), reg_batch),
        case("MeanAbsoluteError", cls(M.MeanAbsoluteError), reg_batch),
        case("MeanSquaredLogError", cls(M.MeanSquaredLogError), reg_batch),
        case("MeanAbsolutePercentageError", cls(M.MeanAbsolutePercentageError), reg_batch),
        case("SymmetricMeanAbsolutePercentageError", cls(M.SymmetricMeanAbsolutePercentageError), reg_batch),
        case("WeightedMeanAbsolutePercentageError", cls(M.WeightedMeanAbsolutePercentageError), reg_batch),
        case("ExplainedVariance", cls(M.ExplainedVariance), reg_batch),
        case("R2Score", cls(M.R2Score), reg_batch),
        case("PearsonCorrCoef", cls(M.PearsonCorrCoef), reg_batch),
        case("ConcordanceCorrCoef", cls(M.ConcordanceCorrCoef), reg_batch),
        case("MinkowskiDistance", cls(M.MinkowskiDistance, p=3), reg_batch),
        case("LogCoshError", cls(M.LogCoshError), reg_batch),
        case("TweedieDevianceScore", cls(M.TweedieDevianceScore, power=1.5),
             lambda r: (_rand(r, _N) + 0.1, _rand(r, _N) + 0.1)),
        case("RelativeSquaredError", cls(M.RelativeSquaredError), reg_batch),
        case("NormalizedRootMeanSquaredError", cls(M.NormalizedRootMeanSquaredError), reg_batch),
        case("CosineSimilarity", cls(M.CosineSimilarity), lambda r: (_rand(r, _N, _C), _rand(r, _N, _C))),
        case("KLDivergence", cls(M.KLDivergence), lambda r: (_probs(r, _N, _C), _probs(r, _N, _C))),
        # ---- aggregation -------------------------------------------------------
        case("MeanMetric", cls(M.MeanMetric), lambda r: (_rand(r, _N),)),
        case("SumMetric", cls(M.SumMetric), lambda r: (_rand(r, _N),)),
        case("MaxMetric", cls(M.MaxMetric), lambda r: (_rand(r, _N),)),
        case("MinMetric", cls(M.MinMetric), lambda r: (_rand(r, _N),)),
        case("RunningMean", cls(M.RunningMean, window=3), lambda r: (_rand(r, _N),)),
        # ---- image -------------------------------------------------------------
        case("PeakSignalNoiseRatio", cls(M.PeakSignalNoiseRatio, data_range=1.0), img_batch),
        case("StructuralSimilarityIndexMeasure", cls(M.StructuralSimilarityIndexMeasure, data_range=1.0),
             img_batch),
        case("UniversalImageQualityIndex", cls(M.UniversalImageQualityIndex), img_batch),
        case("TotalVariation", cls(M.TotalVariation), lambda r: (_rand(r, *_IMG),)),
        case("SpectralAngleMapper", cls(M.SpectralAngleMapper), img_batch),
        case("RelativeAverageSpectralError", cls(M.RelativeAverageSpectralError), img_batch),
        # ---- audio -------------------------------------------------------------
        case("SignalNoiseRatio", cls(M.SignalNoiseRatio), sig_batch),
        case("ScaleInvariantSignalNoiseRatio", cls(M.ScaleInvariantSignalNoiseRatio), sig_batch),
        case("ScaleInvariantSignalDistortionRatio", cls(M.ScaleInvariantSignalDistortionRatio), sig_batch),
        # ---- nominal -----------------------------------------------------------
        case("CramersV", cls(M.CramersV, num_classes=_C), nom_batch),
        case("TschuprowsT", cls(M.TschuprowsT, num_classes=_C), nom_batch),
        case("TheilsU", cls(M.TheilsU, num_classes=_C), nom_batch),
        case("PearsonsContingencyCoefficient", cls(M.PearsonsContingencyCoefficient, num_classes=_C), nom_batch),
        # ---- segmentation / text ----------------------------------------------
        case("MeanIoU", cls(S.MeanIoU, num_classes=_C, input_format="index"), seg_batch),
        case("GeneralizedDiceScore", cls(S.GeneralizedDiceScore, num_classes=_C, input_format="index"), seg_batch),
        case("Perplexity", cls(M.Perplexity), lambda r: (_probs(r, 2, 8, 16), _randint(r, 16, 2, 8))),
        # ---- sketches ----------------------------------------------------------
        case("DDSketch", cls(M.DDSketch, num_buckets=512), lambda r: (_rand(r, _N) + 0.01,)),
        case("HyperLogLog", cls(M.HyperLogLog, p=8), lambda r: (_rand(r, _N),)),
        case("ReservoirSample", cls(M.ReservoirSample, k=16), lambda r: (_rand(r, _N),)),
        case("StreamingAUROC", cls(M.StreamingAUROC, num_bins=128), bin_batch),
        case("StreamingCalibrationError", cls(M.StreamingCalibrationError, num_bins=10), bin_batch),
        # ---- windows & drift (timestamps are 0-d float32 tensors) -------------
        case("TimeDecayed", lambda device: M.TimeDecayed(M.MeanMetric(nan_strategy="disable", device=device),
                                                         half_life_s=60.0),
             lambda r: (_t(5.0), _rand(r, _N))),
        case("TumblingWindow", lambda device: M.TumblingWindow(M.SumMetric(nan_strategy="disable", device=device),
                                                               pane_s=1.0, n_panes=8),
             lambda r: (_t(5.0), _rand(r, _N))),
        case("DecayedDDSketch", cls(M.DecayedDDSketch, half_life_s=60.0, num_buckets=512),
             lambda r: (_t(5.0), _rand(r, _N) + 0.01)),
        case("DecayedHLL", cls(M.DecayedHLL, half_life_s=60.0, p=8), lambda r: (_t(5.0), _rand(r, _N))),
        case("PSI", cls(M.PSI, lo=0.0, hi=1.0, num_bins=32), lambda r: (_rand(r, _N), _rand(r, _N))),
        case("KSDistance", cls(M.KSDistance, lo=0.0, hi=1.0, num_bins=32), lambda r: (_rand(r, _N), _rand(r, _N))),
        case("CUSUM", cls(M.CUSUM, target=0.5, k=0.1, h=5.0), lambda r: (_rand(r, _N),)),
    ]


_CASES_CACHE: Optional[List[ProfileCase]] = None


def _cases() -> List[ProfileCase]:
    global _CASES_CACHE
    if _CASES_CACHE is None:
        _CASES_CACHE = _make_cases()
    return _CASES_CACHE


class _LazyCases:
    """Sequence façade over the lazily-built registry (import stays cheap)."""

    def __iter__(self):
        return iter(_cases())

    def __len__(self):
        return len(_cases())

    def __getitem__(self, i):
        return _cases()[i]


PROFILE_CASES = _LazyCases()
