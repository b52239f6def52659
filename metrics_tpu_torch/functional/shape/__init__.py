"""Shape metrics (counterpart of ``metrics_tpu/functional/shape/__init__.py``)."""

from metrics_tpu_torch.functional.shape.procrustes import procrustes_disparity

__all__ = ["procrustes_disparity"]
