"""Optional-dependency flags (counterpart of ``metrics_tpu/utils/imports.py``): the port's only optional
dependency is matplotlib, for plotting."""

from __future__ import annotations

import importlib.util


def _package_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ModuleNotFoundError, ValueError):
        return False


_MATPLOTLIB_AVAILABLE = _package_available("matplotlib")
