"""Sketch-state metrics: bounded-memory summaries of unbounded streams.

Counterpart of ``metrics_tpu/sketches``. Every class holds fixed-shape states
with a declared associative merge, so shard merges are exact: DDSketch's
relative error α, HyperLogLog's standard error 1.04/√m, the binned AUROC's
same-bin pair mass and the bottom-k reservoir's exact sample. Their updates
read nothing back from the device.
"""

from metrics_tpu_torch.sketches.cardinality import HyperLogLog
from metrics_tpu_torch.sketches.curve import StreamingAUROC, StreamingCalibrationError
from metrics_tpu_torch.sketches.quantile import DDSketch
from metrics_tpu_torch.sketches.sample import ReservoirSample

__all__ = [
    "DDSketch",
    "HyperLogLog",
    "ReservoirSample",
    "StreamingAUROC",
    "StreamingCalibrationError",
]
