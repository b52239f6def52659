"""Regression metrics (counterpart of ``metrics_tpu/regression``).

Ported so far: ``MeanSquaredError`` and ``MeanAbsoluteError`` (``basics.py``),
``PearsonCorrCoef`` and ``SpearmanCorrCoef`` (``correlation.py``). The other
classes of both modules and of the domain are not ported yet.
"""

from metrics_tpu_torch.regression.basics import MeanAbsoluteError, MeanSquaredError
from metrics_tpu_torch.regression.correlation import PearsonCorrCoef, SpearmanCorrCoef

__all__ = ["MeanAbsoluteError", "MeanSquaredError", "PearsonCorrCoef", "SpearmanCorrCoef"]
