"""MetricCollection with compute groups (counterpart of ``metrics_tpu/collections.py``).

A collection updates many metrics from the same inputs. After its first
update it compares the members' states and merges the metrics whose states are
equal into compute groups; later updates run only each group's leader, and
the members share the leader's tensors. The share is safe because the port's
update bodies replace their tensors and never change them in place
(``metrics_tpu_torch/metric.py``); list containers are copied shallowly so
that a member's own later update cannot append to the leader's list.

The JAX package's ``_fused_group_update``, which runs every leader's update
as one compiled program, has no counterpart: the leaders update one after
another.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import _flatten_dict
from metrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = ["CollectionFunctions", "MetricCollection"]


class CollectionFunctions:
    """Pure ``(init, update, compute)`` over a whole :class:`MetricCollection`.

    The state is ``{leader_name: state_dict}``: one state per compute group
    once the groups are known, one per metric before.
    """

    def __init__(self, init, update, compute, reductions=None):
        self.init = init
        self.update = update
        self.compute = compute
        #: per-leader ``{state_name: dist_reduce_fx}`` dicts, for the cross-rank sync
        self.reductions = reductions or {}

    def sync(self, state, group=None):
        """Reduce every leader's state across the ranks of ``group`` (the default group when ``None``)."""
        from metrics_tpu_torch.parallel.sync import sync_states

        return {n: sync_states(st, self.reductions[n], group) for n, st in state.items()}


class MetricCollection:
    """Metrics updated from the same inputs.

    Args:
        metrics: a metric, a sequence of metrics, or a dict of names to metrics (or collections).
        *additional_metrics: more metrics, when ``metrics`` is a metric or a sequence.
        prefix: prepended to every result key.
        postfix: appended to every result key.
        compute_groups: merge metrics whose states are equal after the first update (``True``),
            keep every metric apart (``False``), or a list of groups of member names.

    >>> import torch
    >>> from metrics_tpu_torch.classification import MulticlassAccuracy, MulticlassPrecision, MulticlassRecall
    >>> target = torch.tensor([0, 2, 0, 2, 0, 1, 0, 2])
    >>> preds = torch.tensor([2, 1, 2, 0, 1, 2, 2, 2])
    >>> metrics = MetricCollection([MulticlassAccuracy(num_classes=3, average="micro", device="cpu"),
    ...                             MulticlassPrecision(num_classes=3, average="macro", device="cpu"),
    ...                             MulticlassRecall(num_classes=3, average="macro", device="cpu")])
    >>> metrics.update(preds, target)
    >>> sorted(metrics.compute())
    ['MulticlassAccuracy', 'MulticlassPrecision', 'MulticlassRecall']
    >>> metrics.compute_groups
    {0: ['MulticlassAccuracy'], 1: ['MulticlassPrecision', 'MulticlassRecall']}
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
    ) -> None:
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked = False
        self._state_is_copy = False
        self._modules: "OrderedDict[str, Metric]" = OrderedDict()
        self.add_metrics(metrics, *additional_metrics)

    # ------------------------------------------------------------------ container protocol
    def __getitem__(self, key: str) -> Metric:
        return self._modules[key]

    def __setitem__(self, key: str, value: Metric) -> None:
        if not isinstance(value, Metric):
            raise ValueError(f"Value for key {key!r} should be a Metric but got {type(value)}")
        self._modules[key] = value
        self._groups_checked = False
        if isinstance(self._enable_compute_groups, list):
            if not any(key in group for group in self._groups.values()):
                self._groups[len(self._groups)] = [key]
        else:
            # singleton groups over every member; they merge again at the next update
            self._groups = {i: [name] for i, name in enumerate(self._modules)}

    def __iter__(self):
        return iter(self._modules)

    def __len__(self) -> int:
        return len(self._modules)

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def keys(self, keep_base: bool = False):
        """The metric names; with the prefix and postfix unless ``keep_base``."""
        if keep_base:
            return self._modules.keys()
        return [self._set_name(k) for k in self._modules]

    def values(self):
        """The metrics."""
        return self._modules.values()

    def items(self, keep_base: bool = False):
        """(name, metric) pairs; the names with the prefix and postfix unless ``keep_base``."""
        if keep_base:
            return self._modules.items()
        return [(self._set_name(k), v) for k, v in self._modules.items()]

    # ------------------------------------------------------------------ construction
    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Add metrics to the collection; a sequence names each metric by its class."""
        if isinstance(metrics, str):
            raise ValueError(
                "Unknown input to MetricCollection. Expected a Metric, a sequence of Metrics or a dict,"
                f" but got a string: {metrics!r}"
            )
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence) and not isinstance(metrics, dict):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passes extra arguments {remain} which are not Metrics so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary."
            )
        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `metrics_tpu_torch.Metric` or `metrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of"
                        " `metrics_tpu_torch.Metric` or `metrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if name in self._modules:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        self._modules[k] = v
        else:
            raise ValueError("Unknown input to MetricCollection.")
        self._groups_checked = False
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {i: [name] for i, name in enumerate(self._modules)}

    def _init_compute_groups(self) -> None:
        """Singleton groups to be merged after the first update, or the user's explicit groups."""
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(self._enable_compute_groups))
            for v in self._groups.values():
                for metric in v:
                    if metric not in self._modules:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the collection."
                        )
            self._groups_checked = True
        else:
            self._groups = {i: [name] for i, name in enumerate(self._modules)}

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    # ------------------------------------------------------------------ lifecycle
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every metric; once the groups are known, each group's leader only."""
        if self._state_is_copy:
            self._groups_checked = False
            self._state_is_copy = False
        if self._groups_checked:
            for cg in self._groups.values():
                leader = self._modules[cg[0]]
                leader.update(*args, **leader._filter_kwargs(**kwargs))
            self._share_leader_states()
        else:
            for m in self._modules.values():
                m.update(*args, **m._filter_kwargs(**kwargs))
            # only detected groups are derived again; the user's explicit groups are never merged
            if self._enable_compute_groups is True:
                self._merge_compute_groups()
            self._groups_checked = True

    def _share_leader_states(self) -> None:
        """Members take their leader's tensors (lists as shallow copies) and update count."""
        for cg in self._groups.values():
            leader = self._modules[cg[0]]
            for name in cg[1:]:
                member = self._modules[name]
                member.__dict__["_state"].update({
                    k: (list(leader._state[k]) if isinstance(leader._state[k], list) else leader._state[k])
                    for k in member._defaults
                })
                member._update_count = leader._update_count
                member._computed = None

    def _merge_compute_groups(self) -> None:
        """Merge the groups whose leaders' states are equal (every pair settled by one host read)."""
        keys = list(self._groups.keys())
        leaders = {k: self._modules[self._groups[k][0]] for k in keys}
        equal = self._pairwise_equal_states(keys, leaders)
        num_groups = len(self._groups)
        while True:
            for cg_idx1 in list(self._groups):
                for cg_idx2 in list(self._groups):
                    if cg_idx1 == cg_idx2:
                        continue
                    if equal[(cg_idx1, cg_idx2)]:
                        self._groups[cg_idx1].extend(self._groups.pop(cg_idx2))
                        break
                else:
                    continue
                break
            else:
                break
            if len(self._groups) == num_groups:
                break
            num_groups = len(self._groups)
        self._groups = {i: v for i, v in enumerate(self._groups.values())}

    @classmethod
    def _pairwise_equal_states(cls, keys: List, leaders: Dict) -> Dict:
        """Equality of every pair of leaders' states, with at most one device-to-host read."""
        equal: Dict = {}
        pending: List = []
        for i, k1 in enumerate(keys):
            for k2 in keys[i + 1 :]:
                verdict = cls._structural_equal_states(leaders[k1], leaders[k2])
                if verdict is None:
                    pending.append(((k1, k2), cls._value_equal_device(leaders[k1], leaders[k2])))
                    continue
                equal[(k1, k2)] = equal[(k2, k1)] = verdict
        if pending:
            flat = torch.stack([t.to(pending[0][1].device) for _, t in pending]).tolist()
            for ((k1, k2), _), ok in zip(pending, flat):
                equal[(k1, k2)] = equal[(k2, k1)] = bool(ok)
        return equal

    @staticmethod
    def _structural_equal_states(metric1: Metric, metric2: Metric) -> Optional[bool]:
        """False on any mismatch of names, kinds, shapes or devices; True when the states are the very same
        tensors; None when their values still need comparing."""
        if len(metric1._defaults) == 0 or len(metric2._defaults) == 0:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        all_shared = True
        for key in metric1._defaults:
            s1, s2 = metric1._state[key], metric2._state[key]
            if type(s1) != type(s2):  # noqa: E721
                return False
            pairs = list(zip(s1, s2)) if isinstance(s1, list) else [(s1, s2)]
            if isinstance(s1, list) and len(s1) != len(s2):
                return False
            if any(x.shape != y.shape or x.device != y.device for x, y in pairs):
                return False
            all_shared = all_shared and all(x is y for x, y in pairs)
        return True if all_shared else None

    @staticmethod
    def _value_equal_device(metric1: Metric, metric2: Metric) -> torch.Tensor:
        """0-d bool tensor on the states' device: every state pair allclose (rtol 1e-5, atol 1e-8, as
        ``jnp.allclose``); the caller reads all pairs at once."""
        checks = []
        for key in metric1._defaults:
            s1, s2 = metric1._state[key], metric2._state[key]
            pairs = zip(s1, s2) if isinstance(s1, list) else [(s1, s2)]
            for x, y in pairs:
                y = y.to(x.dtype)
                same = torch.isclose(x, y) if x.is_floating_point() or x.is_complex() else x == y
                checks.append(same.all())
        if not checks:
            return torch.tensor(True)
        return torch.stack(checks).all()

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Each metric's ``forward``: the batch values, while every state accumulates."""
        res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self._modules.items()}
        # forward moves every state on its own, so the sharing is derived again at the next update
        self._groups_checked = False
        res, duplicates = _flatten_dict(res)
        if duplicates:
            rank_zero_warn("Metric output keys overlap after flattening; some results were overwritten.")
        return {self._set_name(k): v for k, v in res.items()}

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def compute(self) -> Dict[str, Any]:
        """Each metric's result, in one flat dict (each metric syncs inside its own ``compute``)."""
        return self._flatten_results({k: m.compute() for k, m in self._modules.items()})

    def plot(self, val: Any = None, ax: Any = None, together: bool = False):
        """Plot each metric's value: one figure per metric, or all on one axis (``together``).

        Args:
            val: a ``compute()``/``forward()`` result dict, or a list of them (one per step);
                defaults to ``compute()``.
            ax: with ``together=True`` a single matplotlib axis; otherwise a sequence of
                axes, one per metric.
            together: plot all metrics onto one shared axis instead of one figure each.

        Returns:
            ``(fig, ax)`` when ``together`` else a list of per-metric ``(fig, ax)`` pairs.
        """
        from metrics_tpu_torch.utils.plot import plot_single_or_multi_val

        if not isinstance(together, bool):
            raise ValueError(f"Expected argument `together` to be a boolean, but got {type(together)}")
        if ax is not None:
            import matplotlib.axes

            if together and not isinstance(ax, matplotlib.axes.Axes):
                raise ValueError(
                    f"Expected argument `ax` to be a matplotlib axis object, but got {type(ax)} when `together=True`"
                )
            if not together and not (isinstance(ax, Sequence) and len(ax) == len(self)):
                raise ValueError(
                    "Expected argument `ax` to be a sequence of matplotlib axis objects of the same "
                    f"length as the number of metrics in the collection, but got {type(ax)} when `together=False`"
                )
        val = val if val is not None else self.compute()
        if together:
            return plot_single_or_multi_val(val, ax=ax)
        fig_axs = []
        for i, (k, m) in enumerate(self.items()):
            if isinstance(val, dict):
                f, a = m.plot(val[k], ax=ax[i] if ax is not None else None)
            elif isinstance(val, Sequence):
                f, a = m.plot([v[k] for v in val], ax=ax[i] if ax is not None else None)
            else:
                raise TypeError(f"Expected argument `val` to be None, a dict, or a sequence of dicts, got {type(val)}")
            fig_axs.append((f, a))
        return fig_axs

    def functional(self) -> CollectionFunctions:
        """Pure ``(init, update, compute)`` over the whole collection.

        Once the groups are known (after the first ``update``) one state per
        group is carried and updated; before, one per metric.
        """
        names = list(self._modules)
        if self._groups_checked:
            leader_of = {n: cg[0] for cg in self._groups.values() for n in cg}
        else:
            leader_of = {n: n for n in names}
        leaders = sorted({leader_of[n] for n in names}, key=names.index)
        lead_fns = {n: self._modules[n].functional() for n in leaders}
        member_fns = {n: (self._modules[n].functional() if n not in lead_fns else lead_fns[n]) for n in names}
        filters = {n: self._modules[n]._filter_kwargs for n in leaders}

        def init() -> Dict[str, Any]:
            return {n: lead_fns[n].init() for n in leaders}

        def update(state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
            return {n: lead_fns[n].update(state[n], *args, **filters[n](**kwargs)) for n in leaders}

        def compute(state: Dict[str, Any]) -> Dict[str, Any]:
            return self._flatten_results({n: member_fns[n].compute(state[leader_of[n]]) for n in names})

        return CollectionFunctions(
            init=init, update=update, compute=compute, reductions={n: lead_fns[n].reductions for n in leaders}
        )

    def _flatten_results(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """One flat dict of every metric's result, with the prefix and postfix (eager and functional alike)."""
        _, duplicates = _flatten_dict(result)
        flat_result = {}
        for k, res in result.items():
            if isinstance(res, dict):
                for key, v in res.items():
                    if duplicates:
                        stripped = key.replace(self.prefix, "") if self.prefix else key
                        stripped = stripped.replace(self.postfix, "") if self.postfix else stripped
                        key = f"{k}_{stripped}"
                    flat_result[key] = v
            else:
                flat_result[k] = res
        return {self._set_name(k): v for k, v in flat_result.items()}

    def reset(self) -> None:
        """Reset every metric; detected groups are derived again at the next update, explicit ones kept."""
        for m in self._modules.values():
            m.reset()
        if self._enable_compute_groups and self._groups_checked:
            self._init_compute_groups()
            self._groups_checked = isinstance(self._enable_compute_groups, list)

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """A deep copy (group members still share their leader's copied tensors), optionally renamed."""
        mc = copy.deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        """Choose whether every metric's states are saved by :meth:`state_dict`."""
        for m in self._modules.values():
            m.persistent(mode)

    def state_dict(self) -> Dict[str, Any]:
        """Every member's ``state_dict()``, keyed by member name."""
        return {name: m.state_dict() for name, m in self._modules.items()}

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> None:
        """Load the members' state dicts; ``strict`` also refuses unknown or missing member names."""
        if strict:
            unexpected = sorted(set(state_dict) - set(self._modules))
            missing = sorted(set(self._modules) - set(state_dict))
            if unexpected or missing:
                raise RuntimeError(
                    f"MetricCollection.load_state_dict: state_dict does not match collection members "
                    f"(missing: {missing or 'none'}, unexpected: {unexpected or 'none'}). "
                    "Pass strict=False to load the intersection."
                )
        for name, sd in state_dict.items():
            if name in self._modules:
                self._modules[name].load_state_dict(sd, strict=strict)

    def set_dtype(self, dst_type: torch.dtype) -> "MetricCollection":
        """Cast every metric's floating states to ``dst_type``."""
        for m in self._modules.values():
            m.set_dtype(dst_type)
        return self

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        """The current compute groups: {index: [leader, members...]}."""
        return self._groups

    @property
    def metric_state(self) -> Dict[str, Dict[str, Any]]:
        """Every metric's state."""
        return {name: m.metric_state for name, m in self._modules.items()}

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "("
        for name, m in self._modules.items():
            repr_str += f"\n  {name}: {m!r}"
        if self.prefix:
            repr_str += f"\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f"\n  postfix={self.postfix}"
        return repr_str + "\n)"
