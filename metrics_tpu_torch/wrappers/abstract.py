"""Abstract wrapper base (counterpart of ``metrics_tpu/wrappers/abstract.py``)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.metric import Metric, resolve_device


def wrapped_device(metrics: Iterable[Any], device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of the wrapped metrics (the members of a ``MetricCollection`` among them), which the wrapper
    takes as its own; metrics on different devices, or a ``device`` other than theirs, raise."""
    from metrics_tpu_torch.collections import MetricCollection

    def key(d: torch.device) -> Tuple[str, Optional[int]]:  # "cuda" is the current CUDA device
        return d.type, torch.cuda.current_device() if d.type == "cuda" and d.index is None else d.index

    members: List[Metric] = []
    for metric in metrics:
        members += list(metric.values()) if isinstance(metric, MetricCollection) else [metric]
    devices = [m.device for m in members] + ([resolve_device(device)] if device is not None else [])
    if len({key(d) for d in devices}) > 1:
        raise ValueError(
            f"A wrapper's metrics must live on one device, got {sorted({str(d) for d in devices})}: construct"
            " every wrapped metric (and the wrapper) with the same `device`."
        )
    return devices[0] if devices else resolve_device(None)


class WrapperMetric(Metric):
    """Base class of metrics that hold other metrics.

    A wrapper registers no states of its own; its children are found among
    its attributes (a metric, a ``MetricCollection``, or lists and dicts of
    them), and persistence, merging and loading recurse into them under
    dotted paths.
    """

    def _children(self) -> List[Tuple[str, Metric]]:
        """(dotted path, metric) for every child metric this wrapper holds."""
        from metrics_tpu_torch.collections import MetricCollection

        def expand(path: str, obj: Any, out: List[Tuple[str, Metric]]) -> None:
            if isinstance(obj, Metric):
                out.append((path, obj))
            elif isinstance(obj, MetricCollection):
                for name, member in obj.items(keep_base=True):
                    out.append((f"{path}.{name}", member))
            elif isinstance(obj, (list, tuple)):
                for i, x in enumerate(obj):
                    if isinstance(x, (Metric, MetricCollection)):
                        expand(f"{path}.{i}", x, out)
            elif isinstance(obj, dict):
                for k, x in obj.items():
                    if isinstance(x, (Metric, MetricCollection)):
                        expand(f"{path}.{k}", x, out)

        out: List[Tuple[str, Metric]] = []
        for attr, value in vars(self).items():
            if not attr.startswith("__"):
                expand(attr, value, out)
        return out

    def to_device(self, device: Union[str, torch.device]) -> "WrapperMetric":
        """Move every child metric, then the wrapper's own states, to ``device``."""
        for _, child in self._children():
            child.to_device(device)
        return super().to_device(device)

    # non-metric state a subclass persists beside its children (e.g. Running's window)
    _extra_state_keys: Tuple[str, ...] = ()

    def _recognized_keys(self, prefix: str = "") -> set:
        """Every key this wrapper (and its children, recursively) could export."""
        keys = {prefix + k for k in self._defaults} | {prefix + "_update_count"}
        keys |= {prefix + k for k in self._extra_state_keys}
        for path, child in self._children():
            child_prefix = f"{prefix}{path}."
            if isinstance(child, WrapperMetric):
                keys |= child._recognized_keys(child_prefix)
            else:
                keys |= {child_prefix + k for k in child._defaults} | {child_prefix + "_update_count"}
        return keys

    def persistent(self, mode: bool = False) -> None:
        """Flag the wrapper's own and every child's states."""
        super().persistent(mode)
        for _, child in self._children():
            child.persistent(mode)

    def merge_state(self, incoming_state: Any) -> None:
        """Merge the own states, then each child with its counterpart at the same path.

        ``full_state_update`` wrappers refuse, as the base class does; a
        different child structure is an error, not a partial merge.
        """
        if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step:
            raise RuntimeError(
                "``merge_state`` is not supported for metrics with ``full_state_update=True`` or "
                "``dist_sync_on_step=True``. Please overwrite the merge_state method in the metric class."
            )
        if not isinstance(incoming_state, self.__class__):
            raise ValueError(
                f"Expected incoming state to be an instance of {self.__class__.__name__} "
                f"but got {type(incoming_state)}"
            )
        own_children = self._children()
        in_children = dict(incoming_state._children())
        if {p for p, _ in own_children} != set(in_children):
            raise ValueError(
                f"Cannot merge {self.__class__.__name__}: child structure differs "
                f"({sorted(p for p, _ in own_children)} vs {sorted(in_children)})"
            )
        incoming_count = incoming_state._update_count
        own_count = self._update_count
        if self._defaults:
            self.__dict__["_state"] = self._merge_state_dicts(
                incoming_state.metric_state, self.metric_state, incoming_count, own_count
            )
        for path, child in own_children:
            child.merge_state(in_children[path])
        self._update_count = own_count + incoming_count
        self._computed = None

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "") -> Dict[str, Any]:
        """The own states plus every child's, under dotted child paths."""
        destination = super().state_dict(destination, prefix)
        for path, child in self._children():
            child.state_dict(destination, prefix=f"{prefix}{path}.")
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True) -> None:
        """Restore the own states plus every child's; ``strict`` also refuses keys no child takes."""
        if strict:
            recognized = self._recognized_keys(prefix)
            unexpected = [k for k in state_dict if k.startswith(prefix) and k not in recognized]
            if unexpected:
                raise RuntimeError(
                    f"Unexpected key(s) in state_dict for {self.__class__.__name__}: {sorted(unexpected)[:8]}"
                    " — the wrapper's structure (children/steps) does not match the checkpoint."
                )
        super().load_state_dict(state_dict, prefix, strict)
        for path, child in self._children():
            child.load_state_dict(state_dict, prefix=f"{prefix}{path}.", strict=strict)
