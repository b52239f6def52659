"""Optional-dependency flags (counterpart of ``metrics_tpu/utils/imports.py``): matplotlib for plotting; scipy
for PIT's assignment from three sources and the audio resampling; nltk for ROUGE's stemmer; regex for
SacreBLEU's ``intl`` tokenizer; pesq, onnxruntime and pystoi for the gated audio metrics."""

from __future__ import annotations

import importlib.util


def _package_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ModuleNotFoundError, ValueError):
        return False


_MATPLOTLIB_AVAILABLE = _package_available("matplotlib")
_SCIPY_AVAILABLE = _package_available("scipy")
_REGEX_AVAILABLE = _package_available("regex")
_NLTK_AVAILABLE = _package_available("nltk")
_ONNXRUNTIME_AVAILABLE = _package_available("onnxruntime")
_PESQ_AVAILABLE = _package_available("pesq")
_PYSTOI_AVAILABLE = _package_available("pystoi")
