"""Dynamic merge-equivalence contracts: split-update-merge against the single stream, class by class
(counterpart of ``metrics_tpu/analysis/merge_contracts.py``).

For every exported :class:`~metrics_tpu_torch.Metric` in :data:`MERGE_CASES`:

1. **single-pass reference**: one metric consumes all batches in order;
2. **split-update-merge**: the batches go to 3 shards with *unequal* batch counts, each shard updates its
   own replica, and the partial states fold back through ``merge_state`` (or the functional
   ``_merge_state_dicts`` fold for ``full_state_update`` classes that refuse it);
3. **shard permutation**: the same fold in a permuted shard order.

==================== =======================================================
MERGE_SOUND          both folds reproduce the single-pass compute
CAT_ORDER_SENSITIVE  the in-order fold matches but a permuted shard order
                     does not: concat-ordered state leaks into the result
MERGE_UNSOUND        even the in-order fold diverges (or merging errors)
==================== =======================================================

The cases draw the JAX package's batches (the same ``np.random.RandomState`` seeds, the same shapes), made
tensors on the metric's device, so the classifications compare class by class. They ratchet against the
``"merge"`` section of ``metrics_tpu_torch/analysis/baselines/distlint_baseline.json``: a class may only
improve. Run with ``python -m metrics_tpu_torch.analysis.cli --pass merge``.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "CLASSIFICATIONS",
    "MERGE_CASES",
    "TIME_SHIFTED_CASES",
    "MergeCase",
    "MergeResult",
    "TimeShiftCase",
    "TimeShiftResult",
    "check_merge_case",
    "check_time_shifted_case",
    "run_merge_contracts",
    "run_time_shifted_contracts",
    "load_merge_baseline",
    "write_merge_baseline",
    "diff_merge_baseline",
]

CLASSIFICATIONS = ("MERGE_SOUND", "CAT_ORDER_SENSITIVE", "MERGE_UNSOUND")
_SEVERITY = {name: i for i, name in enumerate(CLASSIFICATIONS)}

# 4 batches over 3 shards with UNEQUAL counts, plus one non-trivial shard permutation
_N_BATCHES = 4
_SHARD_SPLITS: Tuple[Tuple[int, ...], ...] = ((0, 1), (2,), (3,))
_PERMUTED_ORDER: Tuple[int, ...] = (1, 2, 0)

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class MergeCase:
    """One exported Metric class (``ctor(device)``) plus a deterministic synthetic batch source."""

    name: str  # exported class name: the baseline key
    ctor: Callable[[Device], Any]
    batch: Callable[[np.random.RandomState], Tuple[Any, ...]]
    n_batches: int = _N_BATCHES


@dataclasses.dataclass(frozen=True)
class MergeResult:
    case: MergeCase
    classification: str  # one of CLASSIFICATIONS
    detail: str = ""


def _batch_rng(case: MergeCase, i: int) -> np.random.RandomState:
    return np.random.RandomState(zlib.crc32(f"{case.name}:{i}".encode()) % (2**31))


def _on(batch: Tuple[Any, ...], device: Device) -> Tuple[Any, ...]:
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in batch)


def _batches(case: MergeCase, device: Device) -> List[Tuple[Any, ...]]:
    return [_on(case.batch(_batch_rng(case, i)), device) for i in range(case.n_batches)]


def _leaves(value: Any) -> List[Any]:
    from torch.utils._pytree import tree_leaves

    return tree_leaves(value)


def _as_f64(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _trees_match(a: Any, b: Any, rtol: float = 2e-3, atol: float = 1e-5) -> bool:
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        try:
            xa, ya = _as_f64(x), _as_f64(y)
        except (TypeError, ValueError):
            if x != y:  # non-numeric leaves compare exactly
                return False
            continue
        if xa.shape != ya.shape:
            return False
        if not np.allclose(xa, ya, rtol=rtol, atol=atol, equal_nan=True):
            return False
    return True


def _fold_shards(case: MergeCase, shard_batches: Sequence[Sequence[Tuple[Any, ...]]], device: Device) -> Any:
    """Update one replica per shard, fold the partials (incoming-first, so in shard order), return the
    fold's compute; ``full_state_update`` classes take the functional ``_merge_state_dicts`` fold."""
    replicas = []
    for batches in shard_batches:
        m = case.ctor(device)
        for args in batches:
            m.update(*args)
        replicas.append(m)
    try:
        acc = replicas[-1]
        for m in reversed(replicas[:-1]):
            acc.merge_state(m)
        return acc.compute()
    except RuntimeError as exc:
        if "merge_state" not in str(exc):
            raise
    template = replicas[0]
    state, count = template.metric_state, template._update_count
    for m in replicas[1:]:
        state = template._merge_state_dicts(state, m.metric_state, count, m._update_count)
        count += m._update_count
    holder = case.ctor(device)
    holder.__dict__["_state"] = dict(state)  # donlint: disable=ML001 — the replicas are dropped after the fold
    holder._update_count = count
    return holder.compute()


def check_merge_case(case: MergeCase, device: Device = "cuda") -> MergeResult:
    """Classify one class by split-update-merge against single-pass equivalence; never raises."""
    try:
        batches = _batches(case, device)
        ref = case.ctor(device)
        for args in batches:
            ref.update(*args)
        ref_out = ref.compute()
    except Exception as exc:  # noqa: BLE001 — a broken reference is a harness bug
        return MergeResult(case, "MERGE_UNSOUND", f"reference pass failed: {type(exc).__name__}: {exc}")

    shards = [[batches[i] for i in split] for split in _SHARD_SPLITS]
    try:
        in_order = _fold_shards(case, shards, device)
    except Exception as exc:  # noqa: BLE001 — the error text IS the classification detail
        return MergeResult(case, "MERGE_UNSOUND", f"merge failed: {type(exc).__name__}: {exc}")
    if not _trees_match(ref_out, in_order):
        return MergeResult(case, "MERGE_UNSOUND", "in-order split-update-merge diverges from single-pass compute")
    try:
        permuted = _fold_shards(case, [shards[i] for i in _PERMUTED_ORDER], device)
    except Exception as exc:  # noqa: BLE001
        return MergeResult(case, "MERGE_UNSOUND", f"permuted merge failed: {type(exc).__name__}: {exc}")
    if not _trees_match(ref_out, permuted):
        return MergeResult(case, "CAT_ORDER_SENSITIVE",
                           "merge matches in shard order but diverges under shard permutation")
    return MergeResult(case, "MERGE_SOUND")


# --------------------------------------------------------------------------- registry
# the JAX package's draws: float32 uniforms, integer labels as its x32 int32
def _rand(rng: np.random.RandomState, *shape: int) -> torch.Tensor:
    return torch.from_numpy(rng.rand(*shape).astype(np.float32))


def _randint(rng: np.random.RandomState, hi: int, *shape: int) -> torch.Tensor:
    return torch.from_numpy(rng.randint(0, hi, shape).astype(np.int32))


def _probs(rng: np.random.RandomState, *shape: int) -> torch.Tensor:
    p = rng.rand(*shape).astype(np.float32) + 0.05
    return torch.from_numpy(p / p.sum(-1, keepdims=True))


def _panoptic(rng: np.random.RandomState) -> torch.Tensor:
    cats = rng.choice([0, 1, 6, 7], size=(1, 8, 8))
    inst = rng.randint(0, 3, (1, 8, 8))
    return torch.from_numpy(np.stack([cats, inst], axis=-1).astype(np.int32))


def _stamp(value: float) -> torch.Tensor:
    return torch.tensor(np.float32(value))


_WORDS = ("the", "cat", "sat", "on", "a", "mat", "dog", "ran", "fast", "home")


def _sentence(rng: np.random.RandomState, n: int = 5) -> str:
    return " ".join(_WORDS[i] for i in rng.randint(0, len(_WORDS), n))


def _make_cases() -> List[MergeCase]:
    import metrics_tpu_torch as M
    import metrics_tpu_torch.classification as C
    import metrics_tpu_torch.clustering as CL
    import metrics_tpu_torch.segmentation as S
    import metrics_tpu_torch.text as T

    def case(name, ctor, batch, n_batches=_N_BATCHES):
        return MergeCase(name=name, ctor=ctor, batch=batch, n_batches=n_batches)

    def cls(c: Callable[..., Any], **kw: Any) -> Callable[[Device], Any]:
        return lambda device: c(device=device, **kw)

    bin_batch = lambda r: (_rand(r, 10), _randint(r, 2, 10))  # noqa: E731
    reg_batch = lambda r: (_rand(r, 10), _rand(r, 10))  # noqa: E731
    mc_batch = lambda r: (_rand(r, 10, 3), _randint(r, 3, 10))  # noqa: E731
    ml_batch = lambda r: (_rand(r, 10, 3), _randint(r, 2, 10, 3))  # noqa: E731
    img_batch = lambda r: (_rand(r, 2, 3, 16, 16), _rand(r, 2, 3, 16, 16))  # noqa: E731
    lab_batch = lambda r: (_randint(r, 3, 12), _randint(r, 3, 12))  # noqa: E731
    seg_batch = lambda r: (_randint(r, 3, 2, 8, 8), _randint(r, 3, 2, 8, 8))  # noqa: E731

    return [
        # ---- classification ----------------------------------------------------
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
        case("BinaryAUROC", cls(C.BinaryAUROC), bin_batch),
        case("MulticlassAccuracy", cls(C.MulticlassAccuracy, num_classes=3), mc_batch),
        case("MulticlassConfusionMatrix", cls(C.MulticlassConfusionMatrix, num_classes=3), mc_batch),
        case("MulticlassAveragePrecision", cls(C.MulticlassAveragePrecision, num_classes=3), mc_batch),
        case("MulticlassExactMatch", cls(C.MulticlassExactMatch, num_classes=3),
             lambda r: (_randint(r, 3, 4, 5), _randint(r, 3, 4, 5))),
        case("MultilabelFBetaScore", cls(C.MultilabelFBetaScore, beta=2.0, num_labels=3), ml_batch),
        case("MultilabelRankingLoss", cls(C.MultilabelRankingLoss, num_labels=3),
             lambda r: (_rand(r, 8, 3), _randint(r, 2, 8, 3))),
        # ---- regression --------------------------------------------------------
        case("MeanSquaredError", cls(M.MeanSquaredError), reg_batch),
        case("MeanAbsoluteError", cls(M.MeanAbsoluteError), reg_batch),
        case("MeanSquaredLogError", cls(M.MeanSquaredLogError), reg_batch),
        case("ExplainedVariance", cls(M.ExplainedVariance), reg_batch),
        case("R2Score", cls(M.R2Score), reg_batch),
        case("PearsonCorrCoef", cls(M.PearsonCorrCoef), reg_batch),
        case("SpearmanCorrCoef", cls(M.SpearmanCorrCoef), reg_batch),
        case("KendallRankCorrCoef", cls(M.KendallRankCorrCoef), reg_batch),
        case("ConcordanceCorrCoef", cls(M.ConcordanceCorrCoef), reg_batch),
        case("MinkowskiDistance", cls(M.MinkowskiDistance, p=3), reg_batch),
        case("LogCoshError", cls(M.LogCoshError), reg_batch),
        case("SymmetricMeanAbsolutePercentageError", cls(M.SymmetricMeanAbsolutePercentageError),
             lambda r: (_rand(r, 10) + 0.5, _rand(r, 10) + 0.5)),
        case("CosineSimilarity", cls(M.CosineSimilarity), lambda r: (_rand(r, 6, 4), _rand(r, 6, 4))),
        case("KLDivergence", cls(M.KLDivergence), lambda r: (_probs(r, 6, 4), _probs(r, 6, 4))),
        # ---- aggregation -------------------------------------------------------
        case("MeanMetric", cls(M.MeanMetric), lambda r: (_rand(r, 10),)),
        case("SumMetric", cls(M.SumMetric), lambda r: (_rand(r, 10),)),
        case("MaxMetric", cls(M.MaxMetric), lambda r: (_rand(r, 10),)),
        case("MinMetric", cls(M.MinMetric), lambda r: (_rand(r, 10),)),
        case("CatMetric", cls(M.CatMetric), lambda r: (_rand(r, 10),)),
        case("RunningMean", cls(M.RunningMean, window=3), lambda r: (_rand(r, 10),)),
        # ---- text --------------------------------------------------------------
        case("CharErrorRate", cls(M.CharErrorRate), lambda r: ([_sentence(r)], [_sentence(r)])),
        case("WordErrorRate", cls(M.WordErrorRate), lambda r: ([_sentence(r)], [_sentence(r)])),
        case("BLEUScore", cls(M.BLEUScore), lambda r: ([_sentence(r)], [[_sentence(r, 7)]])),
        case("ROUGEScore", cls(T.ROUGEScore), lambda r: (_sentence(r), _sentence(r))),
        # ---- image -------------------------------------------------------------
        case("PeakSignalNoiseRatio", cls(M.PeakSignalNoiseRatio), img_batch),
        case("StructuralSimilarityIndexMeasure", cls(M.StructuralSimilarityIndexMeasure), img_batch),
        case("UniversalImageQualityIndex", cls(M.UniversalImageQualityIndex), img_batch),
        case("TotalVariation", cls(M.TotalVariation), lambda r: (_rand(r, 2, 3, 8, 8),)),
        # ---- audio -------------------------------------------------------------
        case("SignalNoiseRatio", cls(M.SignalNoiseRatio), lambda r: (_rand(r, 16), _rand(r, 16))),
        case("ScaleInvariantSignalDistortionRatio", cls(M.ScaleInvariantSignalDistortionRatio),
             lambda r: (_rand(r, 2, 16), _rand(r, 2, 16))),
        # ---- clustering / nominal ---------------------------------------------
        case("AdjustedRandScore", cls(CL.AdjustedRandScore), lab_batch),
        case("NormalizedMutualInfoScore", cls(CL.NormalizedMutualInfoScore), lab_batch),
        case("CramersV", cls(M.CramersV, num_classes=3), lambda r: (_randint(r, 3, 20), _randint(r, 3, 20))),
        case("TschuprowsT", cls(M.TschuprowsT, num_classes=3), lambda r: (_randint(r, 3, 20), _randint(r, 3, 20))),
        case("TheilsU", cls(M.TheilsU, num_classes=3), lambda r: (_randint(r, 3, 25), _randint(r, 3, 25))),
        # ---- segmentation / panoptic -------------------------------------------
        case("MeanIoU", cls(S.MeanIoU, num_classes=3, input_format="index"), seg_batch),
        case("GeneralizedDiceScore", cls(S.GeneralizedDiceScore, num_classes=3, input_format="index"), seg_batch),
        case("PanopticQuality", cls(M.PanopticQuality, things={0, 1}, stuffs={6, 7}),
             lambda r: (_panoptic(r), _panoptic(r))),
        # ---- wrappers (they live on their metric's device) ---------------------
        case("MinMaxMetric", lambda d: M.MinMaxMetric(C.BinaryAccuracy(device=d)), bin_batch),
        case("BootStrapper", lambda d: M.BootStrapper(M.MeanSquaredError(device=d), num_bootstraps=4), reg_batch),
        case("ClasswiseWrapper",
             lambda d: M.ClasswiseWrapper(C.MulticlassAccuracy(num_classes=3, average=None, device=d)), mc_batch),
        case("MultioutputWrapper", lambda d: M.MultioutputWrapper(M.MeanSquaredError(device=d), num_outputs=2),
             lambda r: (_rand(r, 10, 2), _rand(r, 10, 2))),
        # ---- sketches (exactly mergeable by construction) ----------------------
        case("DDSketch", cls(M.DDSketch, num_buckets=512), lambda r: (_rand(r, 10) + 0.01,)),
        case("HyperLogLog", cls(M.HyperLogLog, p=8), lambda r: (_rand(r, 10),)),
        case("ReservoirSample", cls(M.ReservoirSample, k=8), lambda r: (_rand(r, 10),)),
        case("StreamingAUROC", cls(M.StreamingAUROC, num_bins=64), bin_batch),
        case("StreamingCalibrationError", cls(M.StreamingCalibrationError, num_bins=10), bin_batch),
        # ---- windows & drift: timestamps drawn per batch, so shards see scrambled times -----
        case("TimeDecayed",
             lambda d: M.TimeDecayed(M.MeanMetric(nan_strategy="disable", device=d), half_life_s=20.0),
             lambda r: (_stamp(r.rand() * 50.0), _rand(r, 10))),
        case("TumblingWindow",
             lambda d: M.TumblingWindow(M.SumMetric(nan_strategy="disable", device=d), pane_s=10.0, n_panes=4),
             lambda r: (_stamp(r.rand() * 50.0), _rand(r, 10))),
        case("DecayedDDSketch", cls(M.DecayedDDSketch, half_life_s=20.0, num_buckets=512),
             lambda r: (_stamp(r.rand() * 50.0), _rand(r, 10) + 0.01)),
        case("DecayedHLL", cls(M.DecayedHLL, half_life_s=20.0, p=8),
             lambda r: (_stamp(r.rand() * 50.0), _rand(r, 10))),
        case("PSI", cls(M.PSI, lo=0.0, hi=1.0, num_bins=16), lambda r: (_rand(r, 10), _rand(r, 10))),
        case("KSDistance", cls(M.KSDistance, lo=0.0, hi=1.0, num_bins=16), lambda r: (_rand(r, 10), _rand(r, 10))),
        case("CUSUM", cls(M.CUSUM, target=0.5, k=0.05, h=2.0), lambda r: (_rand(r, 10),)),
    ]


class _LazyList:
    """A registry built on first use: importing this module stays cheap."""

    def __init__(self, make: Callable[[], List[Any]]) -> None:
        self._make = make
        self._items: Optional[List[Any]] = None

    def _get(self) -> List[Any]:
        if self._items is None:
            self._items = self._make()
        return self._items

    def __iter__(self):
        return iter(self._get())

    def __len__(self) -> int:
        return len(self._get())

    def __getitem__(self, i):
        return self._get()[i]


MERGE_CASES = _LazyList(_make_cases)


def run_merge_contracts(cases: Optional[Sequence[MergeCase]] = None, device: Device = "cuda") -> List[MergeResult]:
    """Classify every case; returns all results (callers apply the baseline)."""
    return [check_merge_case(c, device) for c in (cases if cases is not None else MERGE_CASES)]


# --------------------------------------------------------------------- time-shifted merges
@dataclasses.dataclass(frozen=True)
class TimeShiftCase:
    """One windowed/drift class plus a timestamped stream; ``batch(rng, i)`` is stream position ``i`` with
    increasing timestamps. ``rtol``/``atol`` is the case's declared merge tolerance (0.0: bit-equal)."""

    name: str
    ctor: Callable[[Device], Any]
    batch: Callable[[np.random.RandomState, int], Tuple[Any, ...]]
    rtol: float = 0.0
    atol: float = 0.0
    n_batches: int = 8


@dataclasses.dataclass(frozen=True)
class TimeShiftResult:
    case: TimeShiftCase
    ok: bool
    boundary: int = 0
    detail: str = ""


def check_time_shifted_case(case: TimeShiftCase, device: Device = "cuda") -> TimeShiftResult:
    """Split a timestamped stream at a seeded time boundary, update an early and a late replica, fold them
    (early as incoming) and hold the merge to the single pass within the case's tolerance; never raises."""
    rng0 = np.random.RandomState(zlib.crc32(f"tshift:{case.name}".encode()) % (2**31))
    boundary = int(rng0.randint(1, case.n_batches))
    try:
        batches = [
            _on(case.batch(np.random.RandomState(zlib.crc32(f"tshift:{case.name}:{i}".encode()) % (2**31)), i),
                device)
            for i in range(case.n_batches)
        ]
        ref = case.ctor(device)
        for args in batches:
            ref.update(*args)
        ref_out = ref.compute()
        early, late = case.ctor(device), case.ctor(device)
        for args in batches[:boundary]:
            early.update(*args)
        for args in batches[boundary:]:
            late.update(*args)
        late.merge_state(early)
        merged_out = late.compute()
    except Exception as exc:  # noqa: BLE001 — the error text IS the result detail
        return TimeShiftResult(case, ok=False, boundary=boundary, detail=f"{type(exc).__name__}: {exc}")
    ra, ma = _as_f64(ref_out), _as_f64(merged_out)
    if case.rtol == 0.0 and case.atol == 0.0:
        ok = ra.shape == ma.shape and bool(np.array_equal(ra, ma, equal_nan=True))
        how = "bit-level"
    else:
        ok = ra.shape == ma.shape and bool(np.allclose(ra, ma, rtol=case.rtol, atol=case.atol, equal_nan=True))
        how = f"rtol={case.rtol}, atol={case.atol}"
    if not ok:
        return TimeShiftResult(case, ok=False, boundary=boundary,
                               detail=f"time-shifted merge diverges from single-pass fold ({how}): "
                                      f"single-pass={ra!r} merged={ma!r}")
    return TimeShiftResult(case, ok=True, boundary=boundary)


def _make_time_shifted_cases() -> List[TimeShiftCase]:
    import metrics_tpu_torch as M

    def t(r: np.random.RandomState, i: int) -> torch.Tensor:
        return _stamp(7.0 * i + r.rand() * 5.0)  # strictly increasing, irregular spacing

    case = TimeShiftCase
    return [
        case("TimeDecayed",
             lambda d: M.TimeDecayed(M.MeanMetric(nan_strategy="disable", device=d), half_life_s=15.0),
             lambda r, i: (t(r, i), _rand(r, 10)), rtol=1e-5, atol=1e-6),
        case("DecayedDDSketch", lambda d: M.DecayedDDSketch(half_life_s=15.0, num_buckets=512, device=d),
             lambda r, i: (t(r, i), _rand(r, 10) + 0.01), rtol=1e-5, atol=1e-6),
        case("DecayedHLL", lambda d: M.DecayedHLL(half_life_s=15.0, p=8, device=d),
             lambda r, i: (t(r, i), _rand(r, 10)), rtol=1e-5, atol=1e-6),
        case("TumblingWindow",
             lambda d: M.TumblingWindow(M.SumMetric(nan_strategy="disable", device=d), pane_s=10.0, n_panes=4),
             lambda r, i: (t(r, i), _rand(r, 10)), rtol=1e-6, atol=1e-7),
        case("PSI", lambda d: M.PSI(lo=0.0, hi=1.0, num_bins=16, device=d),
             lambda r, i: (_rand(r, 10), _rand(r, 10))),
        case("KSDistance", lambda d: M.KSDistance(lo=0.0, hi=1.0, num_bins=16, device=d),
             lambda r, i: (_rand(r, 10), _rand(r, 10))),
        case("CUSUM", lambda d: M.CUSUM(target=0.5, k=0.05, h=2.0, device=d),
             lambda r, i: (_rand(r, 10),), rtol=1e-6, atol=1e-7),
    ]


TIME_SHIFTED_CASES = _LazyList(_make_time_shifted_cases)


def run_time_shifted_contracts(
    cases: Optional[Sequence[TimeShiftCase]] = None, device: Device = "cuda"
) -> List[TimeShiftResult]:
    """The time-shifted-merge check of every windows/drift case (expected: no failure)."""
    return [check_time_shifted_case(c, device) for c in (cases if cases is not None else TIME_SHIFTED_CASES)]


# --------------------------------------------------------------------------- baseline
BASELINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines")
DEFAULT_BASELINE = os.path.join(BASELINE_DIR, "distlint_baseline.json")


def load_merge_baseline(path: str) -> Dict[str, str]:
    """The ``"merge"`` section: class name -> classification."""
    from metrics_tpu_torch.analysis.engine import load_baseline_section

    return {str(k): str(v) for k, v in load_baseline_section(path, "merge").items()}


def write_merge_baseline(path: str, results: Sequence[MergeResult]) -> Dict[str, str]:
    """Record every non-SOUND classification."""
    from metrics_tpu_torch.analysis.engine import write_baseline_section

    merge = {
        r.case.name: r.classification
        for r in sorted(results, key=lambda r: r.case.name)
        if r.classification != "MERGE_SOUND"
    }
    write_baseline_section(
        path, "merge", merge,  # type: ignore[arg-type]
        "merge-harness classifications keyed by exported class name (an absent class is MERGE_SOUND). "
        "Regenerate with `python -m metrics_tpu_torch.analysis.cli --pass merge --update-baseline`.",
    )
    return merge


def diff_merge_baseline(
    results: Sequence[MergeResult], baseline: Dict[str, str]
) -> Tuple[List[MergeResult], List[str]]:
    """Split into (regressions worse than baseline, stale/improvable baseline keys)."""
    regressions: List[MergeResult] = []
    observed: Dict[str, str] = {}
    for r in results:
        observed[r.case.name] = r.classification
        allowed = baseline.get(r.case.name, "MERGE_SOUND")
        if _SEVERITY[r.classification] > _SEVERITY.get(allowed, 0):
            regressions.append(r)
    stale = sorted(
        name for name, allowed in baseline.items()
        if name not in observed or _SEVERITY[observed[name]] < _SEVERITY.get(allowed, 0)
    )
    return regressions, stale


def run_merge_check(
    root: str,
    baseline_path: Optional[str] = None,
    update_baseline: bool = False,
    quiet: bool = False,
    report: Optional[Dict[str, Any]] = None,
    device: Device = "cuda",
) -> int:
    """The ``merge`` pass: classify, ratchet, and run the time-shifted check (expected empty)."""
    path = baseline_path or DEFAULT_BASELINE
    results = run_merge_contracts(device=device)
    if update_baseline:
        merge = write_merge_baseline(path, results)
        if not quiet:
            print(f"merge: baseline written to {path} ({len(merge)} non-sound classes)")
        return 0
    baseline = load_merge_baseline(path)
    regressions, stale = diff_merge_baseline(results, baseline)
    tshift = run_time_shifted_contracts(device=device)
    tshift_failures = [r for r in tshift if not r.ok]
    counts = {c: sum(1 for r in results if r.classification == c) for c in CLASSIFICATIONS}
    if report is not None:
        report.update({
            "cases": len(results),
            "classifications": {r.case.name: r.classification for r in results},
            "regressions": [f"{r.case.name}: {r.classification} — {r.detail}" for r in regressions],
            "stale_baseline_keys": stale,
            "time_shift_failures": [f"{r.case.name}: {r.detail}" for r in tshift_failures],
        })
        return 1 if (regressions or tshift_failures) else 0
    for r in regressions:
        print(f"REGRESSION {r.case.name}: {r.classification} "
              f"(baseline {baseline.get(r.case.name, 'MERGE_SOUND')}) — {r.detail}")
    for name in stale:
        print(f"merge: stale baseline entry (class improved or removed): {name}")
    for r in tshift_failures:
        print(f"TIME-SHIFT FAILURE {r.case.name} (boundary={r.boundary}): {r.detail}")
    if not quiet:
        detail = ", ".join(f"{k}={v}" for k, v in counts.items())
        print(f"merge: {len(results)} classes [{detail}], {len(regressions)} regression(s), {len(stale)} stale; "
              f"time-shifted: {len(tshift)} classes, {len(tshift_failures)} failure(s)")
    return 1 if (regressions or tshift_failures) else 0
