"""Baseline files of the observe passes: one JSON object, a top-level "comment" and one object per section.

The format is the JAX package's (``metrics_tpu/analysis/engine.py``): a write rewrites its own section and the
comment and keeps every sibling section, atomically.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from metrics_tpu_torch.utils.io import atomic_write_text


def load_baseline_section(path: str, section: str) -> Dict[str, object]:
    """One named section of a baseline JSON document ({} when absent)."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    value = data.get(section, {})
    return dict(value) if isinstance(value, dict) else {}


def write_baseline_section(
    path: str,
    section: str,
    values: Dict[str, object],
    comment: str,
    seed: Optional[Dict[str, object]] = None,
) -> Dict[str, object]:
    """Rewrite one section (and the comment), keeping every sibling; ``seed`` gives sections to create when
    the file lacks them."""
    payload: Dict[str, object] = {"comment": comment, section: values}
    for k, v in (seed or {}).items():
        payload.setdefault(k, v)
    if os.path.exists(path):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                existing = json.load(fh)
            for k, v in existing.items():
                if k not in ("comment", section):
                    payload[k] = v
        except (OSError, ValueError):
            pass
    atomic_write_text(path, json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return values
