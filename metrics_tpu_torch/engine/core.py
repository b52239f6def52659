"""Shared batched-dispatch core for the replica and fleet engines (counterpart of ``metrics_tpu/engine/core.py``).

Both engines reduce N logical metric instances to ONE call by stacking their
states into dicts of tensors with a leading row axis and running a
``torch.func.vmap`` of the pure update/compute over them. What differs is
only how rows relate to the incoming batch:

- ``gather``: every row sees the SAME batch through its own integer index row
  (bootstrap resampling): state and index rows map, the batch broadcasts.
- ``stacked``: every row sees its own slice of a batch that already carries a
  leading row axis (multioutput).
- ``masked``: every row sees its own batch slice AND a boolean ``keep`` flag;
  rows with ``keep == False`` return their old state tensors bit-exactly
  (``torch.where`` on the row's flag), so padding rows in a partially
  occupied fleet bucket are never contaminated by staging garbage. This is
  the StreamEngine mode.

A *program* is the built vmapped callable (the JAX package's compiled
executable), and a *dispatch* is one call of it. Building is cheap here
(PyTorch runs eagerly: nothing is traced ahead of the call), but the programs
live in :class:`ProgramCache` LRUs all the same, keyed as the JAX package keys
its executables plus the template's device, so the ``<kind>_compile`` /
``<kind>_hit`` / ``<kind>_evict`` counters keep their meaning: a compile is a
new program shape (a capacity, a batch signature), and churn within a
capacity never makes one. The kernels of the update run batched through their
custom ops' ``vmap`` rules (``ops/binned_hist.py``, ``ops/ssim_window.py``):
one launch per wave, whatever the row count.

Nothing is donated: an update returns new tensors and the caller installs
them only after the whole call succeeded, so a failed dispatch leaves every
stacked state as it was. Buffer donation, the donation probation and the AOT
executable cache are JAX-only.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric, _numpy_dtype_name, _squeeze_if_scalar
from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.utils.compute import acc_dtype
from metrics_tpu_torch.utils.exceptions import TraceIneligibleError

__all__ = [
    "DispatchConsumedError",
    "FusedEntry",
    "ProgramCache",
    "TRACER_ERRORS",
    "VmapRefusalError",
    "engine_compute",
    "engine_update",
    "engine_update_fused",
]


class VmapRefusalError(TraceIneligibleError):
    """``torch.func.vmap`` refused an operation of a batched update or compute (a host read, a
    data-dependent shape, an in-place write of batched values into an unbatched tensor, a raw pointer).

    The engines raise it in place of the ``RuntimeError`` that ``vmap`` raises, so that the fallbacks
    can tell a refusal, after which every stacked state is intact and the rows can run eagerly, from any
    other failure."""


# Refusals only: they abort the call before any stacked state is replaced, so the caller can fall back to
# a loop (or, for the fleet engine, demote the wave's sessions to loose eager metrics).
TRACER_ERRORS = (VmapRefusalError, TraceIneligibleError)

# what torch.func.vmap says when it refuses (its errors are plain RuntimeErrors)
_REFUSAL_MARKS = ("vmap", "Batching rule not implemented", "doesn't have storage", "functorch")


def _refusal(exc: BaseException) -> Optional[VmapRefusalError]:
    if isinstance(exc, RuntimeError) and any(mark in str(exc) for mark in _REFUSAL_MARKS):
        return VmapRefusalError(str(exc))
    return None


class DispatchConsumedError(RuntimeError):
    """A fleet dispatch died in a way that leaves the in-memory stacked state unusable, so only durability
    (checkpoint + WAL replay) can bring its rows back.

    The JAX package raises it when a donated dispatch consumed its input buffers. The port donates nothing,
    so ``StreamEngine`` raises it only when a dispatch on a CUDA bucket fails with a CUDA error: such an
    error poisons the card's context, and every tensor on it (the stacked states among them) can no longer
    be read. A sharded fleet catches it per shard and walks the blast-radius ladder one rung further
    (self-heal the shard from its own journal, or demote just that shard to eager loose sessions) while
    every other shard keeps dispatching."""


def _consumed(exc: BaseException, stacked: Sequence[Dict[str, Any]]) -> bool:
    """Whether a failed dispatch left the stacked tensors unreadable: a CUDA error with any of them on a card."""
    cuda = any(isinstance(v, torch.Tensor) and v.is_cuda for st in stacked for v in st.values())
    return cuda and "CUDA error" in str(exc)


class _Program:
    """One built program: the vmapped callable, and the label its counters report."""

    __slots__ = ("fn", "label")

    def __init__(self, fn: Callable[..., Any], label: str) -> None:
        self.fn = fn
        self.label = label

    def __call__(self, *args: Any) -> Any:
        try:
            return self.fn(*args)
        except RuntimeError as exc:
            refused = _refusal(exc)
            if refused is not None:
                raise refused from exc
            raise


class ProgramCache(OrderedDict):
    """LRU of built vmapped engine programs with observe-visible economics.

    ``kind`` namespaces the counters: the replica cache reports
    ``replica_compile/hit/evict``, the fleet cache ``fleet_compile/hit/evict``.
    Eviction events carry the evicted program's engine label so a thrashing
    cache is attributable, not silent.
    """

    def __init__(self, kind: str, max_entries: int) -> None:
        super().__init__()
        self.kind = kind
        self.max_entries = max_entries
        self._labels: Dict[Any, str] = {}

    def lookup(
        self,
        key: Any,
        build: Callable[[], _Program],
        label: str,
        n: int,
        components: Optional[Tuple[Tuple[str, Any], ...]] = None,
    ) -> _Program:
        entry = self.get(key)
        if entry is None:
            if components is not None and _observe.ENABLED:
                # cause attribution: the call site decomposed the key into named components only because
                # telemetry was on
                _observe.note_compile_miss(self.kind, label, components)
            entry = build()
            self[key] = entry
            self._labels[key] = label
            _observe.note_engine_compile(self.kind, label, n)
            if len(self) > self.max_entries:
                evicted_key, _ = self.popitem(last=False)
                _observe.note_engine_evict(self.kind, self._labels.pop(evicted_key, "?"))
        else:
            self.move_to_end(key)
            _observe.note_engine_hit(self.kind, label)
        return entry

    def clear(self) -> None:  # type: ignore[override]
        super().clear()
        self._labels.clear()


# The replica cache object is re-exported by wrappers/replicated.py under its historical name; the fleet
# cache is sized for many (class, capacity, batch signature) buckets since each live signature is a program.
_REPLICA_JIT_CACHE = ProgramCache("replica", 64)
_FLEET_JIT_CACHE = ProgramCache("fleet", 256)


# id(template) -> its configuration key, dropped with the template: a bucket's template never changes its
# configuration, and keying a curve's thresholds (a tensor on the card) at every dispatch would read the card
_TEMPLATE_CONFIG: Dict[int, Any] = {}


def _template_config(template: Metric) -> Any:
    cfg = _TEMPLATE_CONFIG.get(id(template), _TEMPLATE_CONFIG)
    if cfg is _TEMPLATE_CONFIG:
        cfg = _TEMPLATE_CONFIG[id(template)] = template._config_key()
        weakref.finalize(template, _TEMPLATE_CONFIG.pop, id(template), None)
    return cfg


def _template_key(template: Metric) -> Any:
    """The template's program identity: its configuration key and its device (the program makes its
    tensors there; ``config_fingerprint`` leaves the device out on purpose)."""
    return (_template_config(template), str(template.device))


def _key_components(template: Metric, n: int, mode: str, *extra: Tuple[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    """Decompose an engine cache key into named components for attribution.

    The per-row ``capacity`` is its own component, so masked batch avals are reported with their leading
    (capacity-sized) row axis stripped: growing a bucket then attributes as exactly ``capacity``.
    """
    cfg = _template_config(template)
    return (
        ("class", type(template).__name__),
        *(("config:" + k.lstrip("_"), v) for k, v in (cfg[1] if cfg is not None else ())),
        ("device", str(template.device)),
        ("capacity", n),
        ("mode", mode),
        *extra,
        ("acc_dtype", str(acc_dtype())),
    )


def _dtype_name(dtype: Any) -> str:
    return _numpy_dtype_name(dtype) if isinstance(dtype, torch.dtype) else str(dtype)


def _batch_leaf_sig(v: Any) -> Tuple[Any, ...]:
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return ("arr", tuple(v.shape), _dtype_name(v.dtype))
    if v is None:
        return ("none",)
    # a Python scalar enters the body as a constant: key by type, not one program per value
    return ("pyval", type(v).__name__)


def _as_operand(v: Any, device: torch.device) -> Any:
    """A batch leaf as the program takes it: numpy arrays become tensors on the program's device."""
    if isinstance(v, np.ndarray):
        return torch.as_tensor(v, device=device)
    return v


def _clone_rep(template: Metric) -> Metric:
    # a pristine clone is the representative, keeping user instances (and their states) out of the cache
    rep = template.clone()
    rep.reset()
    return rep


def engine_update(
    template: Metric,
    n: int,
    stacked: Dict[str, Any],
    args: Tuple[Any, ...],
    kwargs: Dict[str, Any],
    *,
    gather_idx: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    cache: ProgramCache = _REPLICA_JIT_CACHE,
    label: Optional[str] = None,
) -> Dict[str, Any]:
    """Run one vmapped update over ``n`` stacked row states; returns the new stack.

    Exactly one of ``gather_idx`` / ``mask`` may be given. ``gather_idx`` (shape ``(n, batch)`` integer
    rows) selects each row's resample of the shared batch inside the batched body. ``mask`` (shape ``(n,)``
    bool) runs the masked fleet mode: tensor arguments carry a leading row axis sized to the padded
    capacity, and rows where ``mask`` is False keep their prior state tensors bit-exactly. Without either,
    tensor arguments are expected to already carry a leading row axis (stacked mode).
    """
    if gather_idx is not None and mask is not None:
        raise ValueError("engine_update: gather_idx and mask are mutually exclusive")
    mode = "gather" if gather_idx is not None else ("masked" if mask is not None else "stacked")
    kw_names = tuple(sorted(kwargs))
    flat = tuple(_as_operand(a, template.device) for a in tuple(args) + tuple(kwargs[k] for k in kw_names))
    arr_flags = tuple(isinstance(a, torch.Tensor) for a in flat)
    nargs = len(args)
    if label is None:
        label = f"{type(template).__name__}x{n}"
    if mode == "masked":
        # the masked key pins full batch avals (not just array-ness), so a `fleet_compile` count is a
        # program-shape count: within one entry every dispatch replays the same program
        batch_sig = tuple(_batch_leaf_sig(a) for a in flat)
        key = (_template_key(template), n, mode, nargs, kw_names, batch_sig)
    else:
        key = (_template_key(template), n, mode, nargs, kw_names, arr_flags)
    components = None
    if _observe.ENABLED:
        if mode == "masked":
            batch_comp: Tuple[Any, ...] = tuple(
                (s[0], s[1][1:], s[2]) if s[0] == "arr" and len(s[1]) else s for s in batch_sig
            )
        else:
            batch_comp = arr_flags
        components = _key_components(
            template, n, mode, ("arg_structure", (nargs, kw_names)), ("batch_avals", batch_comp)
        )

    def build() -> _Program:
        upd = _clone_rep(template)._functional_update

        if mode == "gather":

            def one(st, idx, *leaves):
                sel = [torch.index_select(a, 0, idx) if f else a for a, f in zip(leaves, arr_flags)]
                return upd(st, *sel[:nargs], **dict(zip(kw_names, sel[nargs:])))

            in_dims = (0, 0) + (None,) * len(flat)
        elif mode == "masked":

            def one(st, keep, *leaves):
                new = upd(st, *leaves[:nargs], **dict(zip(kw_names, leaves[nargs:])))
                # the row flag selects whole old tensors for inactive rows, so a padding row's state passes
                # through bit-exactly whatever the staging buffers held at its index
                return {k: torch.where(keep, new[k], st[k]) for k in st}

            in_dims = (0, 0) + tuple(0 if f else None for f in arr_flags)
        else:

            def one(st, *leaves):
                return upd(st, *leaves[:nargs], **dict(zip(kw_names, leaves[nargs:])))

            in_dims = (0,) + tuple(0 if f else None for f in arr_flags)
        return _Program(torch.func.vmap(one, in_dims=in_dims), label)

    entry = cache.lookup(key, build, label, n, components)
    if mode == "gather":
        return entry(stacked, gather_idx, *flat)
    if mode == "masked":
        return entry(stacked, mask, *flat)
    return entry(stacked, *flat)


@dataclasses.dataclass
class FusedEntry:
    """One bucket's slice of a fused tick dispatch.

    ``groups`` is the bucket's flush plan in wave order: each ``(args, kwargs, mask)`` triple is one
    masked-vmap application over the padded capacity, so chaining them inside the fused body preserves
    exactly the per-session submission order.

    ``want_values`` asks the program to also emit the bucket's per-row computes and a live-masked
    per-state column sum (the incremental-fold partial). The caller sets it only for buckets whose compute
    runs batched and whose declared merge algebra is all-sum: the partial sums columns unconditionally,
    which is an aggregate only under that algebra.
    """

    template: Metric
    n: int
    stacked: Dict[str, Any]
    groups: Sequence[Tuple[Tuple[Any, ...], Dict[str, Any], Any]]
    want_values: bool = False
    live: Optional[Any] = None  # (n,) bool occupancy; required when want_values
    label: str = ""


def _fused_spec(entry: FusedEntry) -> Tuple[Any, ...]:
    """The static identity of one entry inside the fused cache key: everything that shapes its slice of
    the program."""
    groups_sig = []
    for args, kwargs, _mask in entry.groups:
        kw_names = tuple(sorted(kwargs))
        flat = tuple(args) + tuple(kwargs[k] for k in kw_names)
        groups_sig.append((len(args), kw_names, tuple(_batch_leaf_sig(a) for a in flat)))
    return (_template_key(entry.template), entry.n, tuple(groups_sig), bool(entry.want_values))


def engine_update_fused(
    entries: Sequence[FusedEntry],
    *,
    cache: ProgramCache = _FLEET_JIT_CACHE,
    label: Optional[str] = None,
) -> List[Tuple[Dict[str, Any], Any, Optional[Dict[str, Any]]]]:
    """Run every entry's masked update chain inside ONE program call (one dispatch per shard tick).

    Returns, aligned with ``entries``, ``(new_stacked, values, partial)`` per entry; ``values`` and
    ``partial`` are None unless the entry asked for them. The program chains each bucket's wave groups in
    order (masked update, then the bucket's live-masked partial aggregate), and hands every bucket's new
    tensors back only after the whole chain ran, so a failure leaves every caller's stacked state as it was.

    Failure semantics match :func:`engine_update`: a vmap refusal raises :class:`VmapRefusalError` (one of
    :data:`TRACER_ERRORS`) with every stacked state intact; any other failure surfaces to the caller, which
    walks the blast-radius ladder per bucket.
    """
    if not entries:
        return []
    specs = tuple(_fused_spec(e) for e in entries)
    key = ("fused", specs)
    if label is None:
        label = "+".join(e.label or type(e.template).__name__ for e in entries)
        if len(label) > 120:
            label = f"{label[:117]}..."
    components = None
    if _observe.ENABLED:
        # per-entry decomposition with the same component names the masked path uses, suffixed by bucket
        # label only when the tick chains several buckets, so growing one bucket attributes as "capacity"
        comps: List[Tuple[str, Any]] = [("mode", "fused")]
        if len(entries) > 1:
            comps.append(("buckets", tuple(e.label or type(e.template).__name__ for e in entries)))
        for i, e in enumerate(entries):
            sfx = "" if len(entries) == 1 else f"[{e.label or i}]"
            cfg = _template_config(e.template)
            groups_sig = specs[i][2]
            comps.append((f"class{sfx}", type(e.template).__name__))
            comps.extend((f"config{sfx}:" + k.lstrip("_"), v) for k, v in (cfg[1] if cfg is not None else ()))
            comps.append((f"device{sfx}", str(e.template.device)))
            comps.append((f"capacity{sfx}", e.n))
            comps.append((f"arg_structure{sfx}", tuple((na, kw) for na, kw, _b in groups_sig)))
            comps.append((
                f"batch_avals{sfx}",
                tuple(
                    tuple((s[0], s[1][1:], s[2]) if s[0] == "arr" and len(s[1]) else s for s in bsig)
                    for _na, _kw, bsig in groups_sig
                ),
            ))
            comps.append((f"want_values{sfx}", bool(specs[i][3])))
        comps.append(("acc_dtype", str(acc_dtype())))
        components = tuple(comps)

    def build() -> _Program:
        chains = []
        for i, spec in enumerate(specs):
            _tkey, _n, groups_sig, want_values = spec
            rep = _clone_rep(entries[i].template)
            upd = rep._functional_update
            comp = rep._functional_compute if want_values else None

            def chain(st, gops, live, _upd=upd, _comp=comp, _sig=groups_sig, _want=want_values):
                for (mask, flat), (nargs, kw_names, bsig) in zip(gops, _sig):
                    arr_flags = tuple(s[0] == "arr" for s in bsig)

                    def one(row, keep, *leaves, _f=_upd, _na=nargs, _kw=kw_names):
                        new = _f(row, *leaves[:_na], **dict(zip(_kw, leaves[_na:])))
                        # inactive rows keep their old tensors bit-exactly, as in the masked mode
                        return {k: torch.where(keep, new[k], row[k]) for k in row}

                    in_dims = (0, 0) + tuple(0 if f else None for f in arr_flags)
                    st = torch.func.vmap(one, in_dims=in_dims)(st, mask, *flat)
                if not _want:
                    return st, None, None
                vals = torch.func.vmap(lambda s: _squeeze_if_scalar(_comp(s)))(st)
                part = {
                    k: torch.where(live.reshape(live.shape + (1,) * (v.ndim - 1)), v, torch.zeros((), dtype=v.dtype,
                                   device=v.device)).sum(0)
                    for k, v in st.items()
                }
                return st, vals, part

            chains.append(chain)

        def fused(states, aux):
            return [chains[i](states[i], *aux[i]) for i in range(len(chains))]

        return _Program(fused, label)

    entry = cache.lookup(key, build, label, max(e.n for e in entries), components)
    states = [e.stacked for e in entries]
    aux = []
    for e, spec in zip(entries, specs):
        device = e.template.device
        gops = []
        for (args, kwargs, mask), (_na, kw_names, _b) in zip(e.groups, spec[2]):
            flat = tuple(_as_operand(a, device) for a in tuple(args) + tuple(kwargs[k] for k in kw_names))
            gops.append((mask, flat))
        live = e.live
        if spec[3] and not isinstance(e.live, torch.Tensor):
            live = torch.from_numpy(np.asarray(e.live, dtype=bool))
            # from pinned memory a copy to the card does not wait for it (a pageable one would)
            live = live.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else live.to(device)
        aux.append((gops, live))
    return [tuple(r) for r in entry(states, aux)]  # type: ignore[misc]


def engine_compute(
    template: Metric,
    n: int,
    stacked: Dict[str, Any],
    *,
    cache: ProgramCache = _REPLICA_JIT_CACHE,
    label: Optional[str] = None,
) -> Any:
    """Vmapped compute over the stacked states: per-row values with a leading axis.

    ``_squeeze_if_scalar`` runs inside the mapped body so each row's value matches what its
    ``Metric.compute()`` would have returned. The stacked states are left as they were.
    """
    if label is None:
        label = f"{type(template).__name__}x{n}"
    key = (_template_key(template), n, "compute")
    components = _key_components(template, n, "compute") if _observe.ENABLED else None

    def build() -> _Program:
        comp = _clone_rep(template)._functional_compute
        return _Program(torch.func.vmap(lambda st: _squeeze_if_scalar(comp(st))), label)

    entry = cache.lookup(key, build, label, n, components)
    return entry(stacked)
