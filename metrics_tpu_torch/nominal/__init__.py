"""Modular nominal-association metrics (counterpart of ``metrics_tpu/nominal/__init__.py``)."""

from metrics_tpu_torch.nominal.metrics import (
    CramersV,
    FleissKappa,
    PearsonsContingencyCoefficient,
    TheilsU,
    TschuprowsT,
)

__all__ = ["CramersV", "FleissKappa", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT"]
