"""Dispatch-side names of the cache (counterpart of ``metrics_tpu/aot/runtime.py``).

The JAX package consults its disk cache before tracing a metric's update (``AotBinding``). A port update
runs eagerly and traces nothing, so no class's dispatch reads the cache: :func:`active` is False for every
class, and ``AotBinding`` has no counterpart. :func:`call_signature` keeps the JAX package's rendering of
one call, so a numpy call signs the same in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

__all__ = ["active", "call_signature"]


def active() -> bool:
    """Whether a metric's dispatch consults the disk: never, since no port update compiles a program."""
    return False


def _flatten(node: Any, leaves: List[Any]) -> str:
    """The JAX pytree rendering of ``node`` (tuples, lists, dicts by sorted key, ``None``); leaves appended."""
    if node is None:
        return "None"
    if isinstance(node, tuple):
        inner = [_flatten(x, leaves) for x in node]
        return "(" + inner[0] + ",)" if len(inner) == 1 else "(" + ", ".join(inner) + ")"
    if isinstance(node, list):
        return "[" + ", ".join(_flatten(x, leaves) for x in node) + "]"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(node[k], leaves)}" for k in sorted(node)) + "}"
    leaves.append(node)
    return "*"


def call_signature(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Tuple[Any, ...]:
    """Stable signature of one concrete call: ``("arr", shape, dtype, weak_type)`` per array leaf (a tensor's
    dtype by its numpy name), ``("py", type name)`` per other leaf, and the tree structure, rendered from
    primitives only so that its repr is process-stable."""
    leaves: List[Any] = []
    treedef = "PyTreeDef(" + _flatten((args, kwargs), leaves) + ")"
    sig = []
    for v in leaves:
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            dtype = str(v.dtype)
            sig.append(("arr", tuple(int(s) for s in v.shape), dtype.replace("torch.", ""), False))
        else:
            sig.append(("py", type(v).__name__))
    return (tuple(sig), treedef)
