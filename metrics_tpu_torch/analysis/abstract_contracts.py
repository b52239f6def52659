"""Shape contracts: every registered functional kernel traced on fake tensors (counterpart of
``metrics_tpu/analysis/abstract_contracts.py``).

The AST rules (JL001-JL006) are heuristic; this module is the ground truth. Each :class:`KernelContract` names a
public functional kernel and a canonical input signature (the JAX package's table, at its sizes
``_N, _C, _L = 12, 4, 3``). :func:`trace_contract` runs the kernel under ``torch._subclasses.FakeTensorMode``,
where ``jax.eval_shape`` runs the JAX package's: no FLOPs, no host transfers, but a real trace through every
op, so a host read of a value (``.item()``, ``bool(t)``, ``torch.unique``, an output size that depends on the
data) raises here even where the static pass missed it. Value checks a kernel makes under
``validate_args=True`` skip on fake tensors, as under ``vmap`` (:func:`metrics_tpu_torch.utils.checks._is_traced`).
The three kernel ops (B1's ``binned_counts``/``binned_counts_labels`` and B2's ``ssim_window``) answer through
their fake implementations, on fake CPU tensors as on fake CUDA tensors (the wrappers' card branch).

The harness also holds the dtype half of the contract: under the float32 regime no kernel may return a 64-bit
float or complex leaf. The port's counters are int64 (``count_dtype()``), so an int64 leaf is allowed where the
JAX package's is int32.

Run via ``tests/test_torch_analysis_more.py`` or ``python -m metrics_tpu_torch.analysis.abstract_contracts
[--device cpu]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

__all__ = [
    "CONTRACTS",
    "ContractResult",
    "KernelContract",
    "trace_contract",
    "verify_contracts",
]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype: an input a contract traces abstractly, or a traced output."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def f32(*shape: int) -> TensorSpec:
    return TensorSpec(tuple(shape), torch.float32)


def i32(*shape: int) -> TensorSpec:
    return TensorSpec(tuple(shape), torch.int32)


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """One functional kernel plus a canonical input signature."""

    name: str  # dotted path under metrics_tpu_torch.functional
    args: Tuple[Any, ...]  # TensorSpecs trace as fake tensors; the rest is static
    kwargs: Optional[Dict[str, Any]] = None


@dataclasses.dataclass(frozen=True)
class ContractResult:
    contract: KernelContract
    ok: bool
    outputs: Any = None  # the output pytree with each tensor as its TensorSpec
    error: str = ""


# canonical problem sizes (the JAX package's)
_N, _C, _L = 12, 4, 3

CONTRACTS: List[KernelContract] = [
    # ---- classification (binary probabilistic) --------------------------------
    KernelContract("accuracy", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("precision", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("recall", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("f1_score", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("fbeta_score", (f32(_N), i32(_N)), {"task": "binary", "beta": 0.5}),
    KernelContract("specificity", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("stat_scores", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("confusion_matrix", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("hamming_distance", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("jaccard_index", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("matthews_corrcoef", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("cohen_kappa", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("negative_predictive_value", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract("critical_success_index", (f32(_N), f32(_N), 0.5)),
    KernelContract("hinge_loss", (f32(_N), i32(_N)), {"task": "binary"}),
    KernelContract(
        "calibration_error", (f32(_N), i32(_N)), {"task": "binary", "n_bins": 5}
    ),
    # binned curve family: thresholds=int keeps every shape static (§7 path)
    KernelContract("auroc", (f32(_N), i32(_N)), {"task": "binary", "thresholds": 16}),
    KernelContract(
        "average_precision", (f32(_N), i32(_N)), {"task": "binary", "thresholds": 16}
    ),
    KernelContract("roc", (f32(_N), i32(_N)), {"task": "binary", "thresholds": 16}),
    KernelContract(
        "precision_recall_curve", (f32(_N), i32(_N)), {"task": "binary", "thresholds": 16}
    ),
    # ---- classification (multiclass) ------------------------------------------
    KernelContract(
        "accuracy", (f32(_N, _C), i32(_N)), {"task": "multiclass", "num_classes": _C}
    ),
    KernelContract(
        "confusion_matrix", (f32(_N, _C), i32(_N)), {"task": "multiclass", "num_classes": _C}
    ),
    KernelContract(
        "auroc", (f32(_N, _C), i32(_N)),
        {"task": "multiclass", "num_classes": _C, "thresholds": 16},
    ),
    KernelContract("dice", (i32(_N), i32(_N)), {"num_classes": _C}),
    # ---- regression ------------------------------------------------------------
    KernelContract("mean_squared_error", (f32(_N), f32(_N))),
    KernelContract("mean_absolute_error", (f32(_N), f32(_N))),
    KernelContract("mean_squared_log_error", (f32(_N), f32(_N))),
    KernelContract("mean_absolute_percentage_error", (f32(_N), f32(_N))),
    KernelContract("symmetric_mean_absolute_percentage_error", (f32(_N), f32(_N))),
    KernelContract("weighted_mean_absolute_percentage_error", (f32(_N), f32(_N))),
    KernelContract("normalized_root_mean_squared_error", (f32(_N), f32(_N))),
    KernelContract("explained_variance", (f32(_N), f32(_N))),
    KernelContract("r2_score", (f32(_N), f32(_N))),
    KernelContract("r2_score", (f32(_N), f32(_N)), {"adjusted": 2}),
    KernelContract("pearson_corrcoef", (f32(_N), f32(_N))),
    KernelContract("spearman_corrcoef", (f32(_N), f32(_N))),
    KernelContract("concordance_corrcoef", (f32(_N), f32(_N))),
    KernelContract("cosine_similarity", (f32(_N, _C), f32(_N, _C))),
    KernelContract("kl_divergence", (f32(_N, _C), f32(_N, _C))),
    KernelContract("log_cosh_error", (f32(_N), f32(_N))),
    KernelContract("minkowski_distance", (f32(_N), f32(_N), 3.0)),
    KernelContract("tweedie_deviance_score", (f32(_N), f32(_N)), {"power": 1.5}),
    KernelContract("relative_squared_error", (f32(_N), f32(_N))),
    # ---- pairwise --------------------------------------------------------------
    KernelContract("pairwise_cosine_similarity", (f32(_N, _C),)),
    KernelContract("pairwise_euclidean_distance", (f32(_N, _C),)),
    KernelContract("pairwise_manhattan_distance", (f32(_N, _C),)),
    KernelContract("pairwise_linear_similarity", (f32(_N, _C),)),
    KernelContract("pairwise_minkowski_distance", (f32(_N, _C),), {"exponent": 3.0}),
    # ---- image -----------------------------------------------------------------
    KernelContract("peak_signal_noise_ratio", (f32(2, 3, 16, 16), f32(2, 3, 16, 16)), {"data_range": 1.0}),
    KernelContract("structural_similarity_index_measure", (f32(2, 3, 16, 16), f32(2, 3, 16, 16)), {"data_range": 1.0}),
    KernelContract("total_variation", (f32(2, 3, 16, 16),)),
    KernelContract("universal_image_quality_index", (f32(2, 3, 16, 16), f32(2, 3, 16, 16))),
    KernelContract("image_gradients", (f32(2, 3, 16, 16),)),
    KernelContract("spectral_angle_mapper", (f32(2, 3, 16, 16), f32(2, 3, 16, 16))),
    KernelContract(
        "error_relative_global_dimensionless_synthesis",
        (f32(2, 3, 16, 16), f32(2, 3, 16, 16)),
    ),
    KernelContract("relative_average_spectral_error", (f32(2, 3, 16, 16), f32(2, 3, 16, 16))),
    # ---- audio -----------------------------------------------------------------
    KernelContract("signal_noise_ratio", (f32(_N, 256), f32(_N, 256))),
    KernelContract("scale_invariant_signal_noise_ratio", (f32(_N, 256), f32(_N, 256))),
    KernelContract("scale_invariant_signal_distortion_ratio", (f32(_N, 256), f32(_N, 256))),
    # ---- retrieval (indexes are int group labels: shapes stay static) ----------
    KernelContract("retrieval_precision", (f32(_N), i32(_N)), {"top_k": 4}),
    KernelContract("retrieval_recall", (f32(_N), i32(_N)), {"top_k": 4}),
    KernelContract("retrieval_fall_out", (f32(_N), i32(_N)), {"top_k": 4}),
    KernelContract("retrieval_hit_rate", (f32(_N), i32(_N)), {"top_k": 4}),
    KernelContract("retrieval_average_precision", (f32(_N), i32(_N))),
    KernelContract("retrieval_reciprocal_rank", (f32(_N), i32(_N))),
    KernelContract("retrieval_normalized_dcg", (f32(_N), i32(_N))),
    # ---- text (tensor-shaped) --------------------------------------------------
    KernelContract("perplexity", (f32(2, 8, 16), i32(2, 8))),
    # ---- segmentation ----------------------------------------------------------
    KernelContract(
        "segmentation.mean_iou", (i32(2, _C, 16, 16), i32(2, _C, 16, 16)),
        {"num_classes": _C, "input_format": "one-hot"},
    ),
    KernelContract(
        "segmentation.generalized_dice_score", (i32(2, _C, 16, 16), i32(2, _C, 16, 16)),
        {"num_classes": _C, "input_format": "one-hot"},
    ),
    # ---- sketches (fixed-shape mergeable stream state) -------------------------
    KernelContract(
        "sketches.ddsketch_delta", (f32(_N), i32(_N)),
        {"alpha": 0.01, "key_offset": -64, "num_buckets": 128},
    ),
    KernelContract(
        "sketches.ddsketch_quantiles", (i32(128), i32(128), i32()),
        {"quantiles": (0.5, 0.99), "alpha": 0.01, "key_offset": -64},
    ),
    KernelContract("sketches.hll_delta", (f32(_N), i32(_N)), {"p": 8}),
    KernelContract("sketches.hll_estimate", (i32(256),)),
    KernelContract("sketches.reservoir_fold", (f32(3, 8), f32(_N), i32(_N)), {"seed": 7}),
    KernelContract("sketches.reservoir_merge", (f32(2, 3, 8),)),
    KernelContract("sketches.score_hist_delta", (f32(_N), i32(_N), i32(_N)), {"num_bins": 32}),
    KernelContract("sketches.binned_auroc", (i32(32), i32(32))),
    KernelContract("sketches.calibration_delta", (f32(_N), i32(_N), i32(_N)), {"num_bins": 10}),
    KernelContract("sketches.binned_ece", (f32(10), i32(10), i32(10))),
]



def _resolve(name: str) -> Any:
    import metrics_tpu_torch.functional as F

    obj: Any = F
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


# 64-bit floats and complex numbers leave the float32 regime; int64 is the port's counter type
_DISALLOWED_DTYPES = (torch.float64, torch.complex128)


def trace_contract(contract: KernelContract, device: Union[str, torch.device] = "cpu") -> ContractResult:
    """Trace one kernel on fake tensors on ``device``; a failure carries the error's message."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_leaves, tree_map

    try:
        fn = _resolve(contract.name)
        with FakeTensorMode():
            full = [torch.empty(a.shape, dtype=a.dtype, device=device) if isinstance(a, TensorSpec) else a
                    for a in contract.args]
            out = fn(*full, **(contract.kwargs or {}))
        outputs = tree_map(lambda x: TensorSpec(tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else x, out)
    except Exception as exc:  # noqa: BLE001 — the error text IS the result
        return ContractResult(contract, ok=False, error=f"{type(exc).__name__}: {exc}")
    bad = [leaf.dtype for leaf in tree_leaves(outputs)
           if isinstance(leaf, TensorSpec) and leaf.dtype in _DISALLOWED_DTYPES]
    if bad and torch.get_default_dtype() != torch.float64:
        return ContractResult(contract, ok=False, outputs=outputs,
                              error=f"64-bit output leaves under the float32 regime: {[str(b) for b in bad]}")
    return ContractResult(contract, ok=True, outputs=outputs)


def verify_contracts(contracts: Optional[List[KernelContract]] = None,
                     device: Union[str, torch.device] = "cpu") -> List[ContractResult]:
    """Trace every contract on ``device``; returns all results (callers filter failures)."""
    return [trace_contract(c, device) for c in (contracts if contracts is not None else CONTRACTS)]


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="abstract-contracts", description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="the fake tensors' device (default: the card's)")
    args = p.parse_args(argv)
    results = verify_contracts(device=args.device)
    failures = [r for r in results if not r.ok]
    for r in failures:
        kw = f", kwargs={r.contract.kwargs}" if r.contract.kwargs else ""
        print(f"FAIL {r.contract.name}{kw}: {r.error}")
    print(f"abstract contracts: {len(results) - len(failures)}/{len(results)} kernels trace cleanly")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
