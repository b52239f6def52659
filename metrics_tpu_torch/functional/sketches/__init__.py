"""Functional sketches: fixed-shape mergeable summaries of unbounded streams.

Counterpart of ``metrics_tpu/functional/sketches``: each function folds one
batch into fixed-shape state deltas, or evaluates the estimate from the
state, with plain tensor operations on the inputs' device and no host read.
The classes of :mod:`metrics_tpu_torch.sketches` carry the states.
"""

from metrics_tpu_torch.functional.sketches.ddsketch import (
    ddsketch_delta,
    ddsketch_gamma,
    ddsketch_quantiles,
)
from metrics_tpu_torch.functional.sketches.ecdf import (
    binned_auroc,
    binned_auroc_bound,
    binned_ece,
    calibration_delta,
    score_hist_delta,
    uniform_edges,
)
from metrics_tpu_torch.functional.sketches.hashing import fmix32, hash32
from metrics_tpu_torch.functional.sketches.hll import hll_delta, hll_estimate, hll_std_error
from metrics_tpu_torch.functional.sketches.reservoir import (
    reservoir_empty,
    reservoir_fold,
    reservoir_merge,
    reservoir_values,
)

__all__ = [
    "binned_auroc",
    "binned_auroc_bound",
    "binned_ece",
    "calibration_delta",
    "ddsketch_delta",
    "ddsketch_gamma",
    "ddsketch_quantiles",
    "fmix32",
    "hash32",
    "hll_delta",
    "hll_estimate",
    "hll_std_error",
    "reservoir_empty",
    "reservoir_fold",
    "reservoir_merge",
    "reservoir_values",
    "score_hist_delta",
    "uniform_edges",
]
