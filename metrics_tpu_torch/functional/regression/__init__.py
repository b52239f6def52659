"""Functional regression metrics (counterpart of ``metrics_tpu/functional/regression``).

Ported so far: mean squared and mean absolute error, Pearson's and Spearman's
correlation. The other functions of the JAX package's regression domain are
not ported yet.
"""

from metrics_tpu_torch.functional.regression.mae import mean_absolute_error
from metrics_tpu_torch.functional.regression.mse import mean_squared_error
from metrics_tpu_torch.functional.regression.pearson import pearson_corrcoef
from metrics_tpu_torch.functional.regression.spearman import spearman_corrcoef

__all__ = ["mean_absolute_error", "mean_squared_error", "pearson_corrcoef", "spearman_corrcoef"]
