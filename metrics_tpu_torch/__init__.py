"""metrics_tpu_torch: the PyTorch/CUDA port of ``metrics_tpu``.

The package keeps the JAX package's module layout and names, so each module has
an obvious counterpart in ``metrics_tpu/``. Metric state lives on an explicit
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``); the two Pallas
kernels of the JAX package are hand-written CUDA kernels under ``csrc/``, built
with ``nvcc`` at first use and launched through ``ops/``.
"""

from metrics_tpu_torch.aggregation import (
    CatMetric,
    MaxMetric,
    MeanMetric,
    MinMetric,
    RunningMean,
    RunningSum,
    SumMetric,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import CompositionalMetric, Metric

__version__ = "0.1.0"

__all__ = [
    "CatMetric",
    "CompositionalMetric",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MinMetric",
    "RunningMean",
    "RunningSum",
    "SumMetric",
]
