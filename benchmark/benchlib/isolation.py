"""What a rank's process loaded: modules the benchmark must never load, and kernel libraries it built."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "metrics_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must never load, compared whole."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def built_libraries() -> List[str]:
    """The port's kernel libraries this process compiled rather than found built (its loader's record, read
    only when the program has loaded it)."""
    native = sys.modules.get("metrics_tpu_torch.ops._native")
    outcomes = getattr(native, "build_outcomes", None) or {}
    return sorted(name for name, how in outcomes.items() if how != "hit")
