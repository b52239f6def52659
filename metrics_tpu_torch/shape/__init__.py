"""Modular shape metrics (counterpart of ``metrics_tpu/shape/__init__.py``)."""

from metrics_tpu_torch.shape.procrustes import ProcrustesDisparity

__all__ = ["ProcrustesDisparity"]
