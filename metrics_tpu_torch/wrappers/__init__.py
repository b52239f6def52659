"""Wrapper metrics (counterpart of ``metrics_tpu/wrappers``).

Ported: ``WrapperMetric``, ``BootStrapper``, ``ClasswiseWrapper``,
``MinMaxMetric``, ``MultioutputWrapper``, ``MultitaskWrapper``, ``Running``
(on which ``RunningMean`` and ``RunningSum`` stand), ``MetricTracker`` and the
input transformers. Not ported yet: ``ReplicatedWrapper``, the JAX package's
vmapped replica engine, which waits for the port of its engine, and
``FeatureShare``/``NetworkCache``, which wait for the metrics whose network
they share (FID, KID, IS).
"""

from metrics_tpu_torch.wrappers.abstract import WrapperMetric
from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from metrics_tpu_torch.wrappers.classwise import ClasswiseWrapper
from metrics_tpu_torch.wrappers.minmax import MinMaxMetric
from metrics_tpu_torch.wrappers.multioutput import MultioutputWrapper
from metrics_tpu_torch.wrappers.multitask import MultitaskWrapper
from metrics_tpu_torch.wrappers.running import Running
from metrics_tpu_torch.wrappers.tracker import MetricTracker
from metrics_tpu_torch.wrappers.transformations import (
    BinaryTargetTransformer,
    LambdaInputTransformer,
    MetricInputTransformer,
)

__all__ = [
    "BinaryTargetTransformer",
    "BootStrapper",
    "ClasswiseWrapper",
    "LambdaInputTransformer",
    "MetricInputTransformer",
    "MetricTracker",
    "MinMaxMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "Running",
    "WrapperMetric",
]
