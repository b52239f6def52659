"""Wrapper metrics (counterpart of ``metrics_tpu/wrappers``).

Every wrapper of the JAX package is ported: ``WrapperMetric``, ``BootStrapper``,
``ClasswiseWrapper``, ``FeatureShare`` and ``NetworkCache``, ``MinMaxMetric``,
``MultioutputWrapper``, ``MultitaskWrapper``, ``ReplicatedWrapper`` (the vmapped
replica engine), ``Running`` (on which ``RunningMean`` and ``RunningSum`` stand),
``MetricTracker`` and the input transformers.
"""

from metrics_tpu_torch.wrappers.abstract import WrapperMetric
from metrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from metrics_tpu_torch.wrappers.classwise import ClasswiseWrapper
from metrics_tpu_torch.wrappers.feature_share import FeatureShare, NetworkCache
from metrics_tpu_torch.wrappers.minmax import MinMaxMetric
from metrics_tpu_torch.wrappers.multioutput import MultioutputWrapper
from metrics_tpu_torch.wrappers.multitask import MultitaskWrapper
from metrics_tpu_torch.wrappers.replicated import ReplicatedWrapper
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
    "FeatureShare",
    "LambdaInputTransformer",
    "MetricInputTransformer",
    "MetricTracker",
    "MinMaxMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "NetworkCache",
    "ReplicatedWrapper",
    "Running",
    "WrapperMetric",
]
