"""State synchronization over ``torch.distributed`` (counterpart of ``metrics_tpu/parallel/sync.py``).

A metric's states are reduced across the ranks of a process group by each
state's declared reduction:

    sum, min, max -> all_reduce with SUM, MIN, MAX
    mean          -> all_reduce with SUM, divided by the world size
    cat, None     -> all_gather (ragged: sizes first, pad, gather, trim)
    custom        -> all_gather, then the callable on the gathered stack

The JAX package lowers these to XLA collectives over a device mesh; here they
are ``torch.distributed`` collectives over a process group: NCCL for CUDA
tensors (one rank per device), gloo for CPU tensors and CUDA ones alike. :func:`allreduce_over_mesh` keeps its name
but folds N ranks' states held in one process, on one device, with no process
group: the JAX package's own multi-rank rig without the mesh. It and
:func:`sync_states` share :func:`reduce_gathered`, the one function that
applies a reduction to the per-rank values, so that the two differ only in
where those values come from.

``shard_map_compat`` and ``build_mesh`` have no counterpart: a process group
takes the place of a mesh axis.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, TypeVar, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.metric import _REDUCE_ALIASES
from metrics_tpu_torch.observe import recorder as _observe
from metrics_tpu_torch.observe import tracing as _tracing
from metrics_tpu_torch.utils.data import (
    _mean_dtype,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

_BUILTIN_REDUCTIONS = tuple(_REDUCE_ALIASES.values())

__all__ = [
    "SyncPeerLostError",
    "SyncPolicy",
    "allreduce_over_mesh",
    "gather_all_states",
    "get_sync_policy",
    "pad_to_capacity",
    "reduce_gathered",
    "run_with_retries",
    "seed_retry_jitter",
    "set_sync_policy",
    "sync_policy",
    "sync_states",
]

_T = TypeVar("_T")


# ------------------------------------------------------------------ degraded-sync policy
@dataclasses.dataclass(frozen=True)
class SyncPolicy:
    """How ``Metric.sync`` behaves when a collective fails.

    - ``retries``: extra attempts after the first failure, each preceded by an
      exponentially growing sleep starting at ``backoff_s``.
    - ``timeout_s``: total retry budget in seconds; once exceeded, no further
      attempt is made even if ``retries`` remain. ``None`` = unbounded.
    - ``partial_merge``: when the final attempt still fails, degrade to a
      count-weighted merge of the surviving shards (the local state plus any
      survivors a :class:`SyncPeerLostError` carried) instead of raising.
    - ``jitter``: bounded randomization of each backoff sleep, drawn uniformly
      from ``[delay * (1 - jitter), delay * (1 + jitter)]`` so that peers which
      failed at the same instant do not retry at the same instant. Must lie in
      ``[0, 1]``; ``0`` disables it. :func:`seed_retry_jitter` makes the
      sequence reproducible.
    """

    retries: int = 0
    backoff_s: float = 0.05
    timeout_s: Optional[float] = None
    partial_merge: bool = False
    jitter: float = 0.25


_SYNC_POLICY = SyncPolicy()


def get_sync_policy() -> SyncPolicy:
    return _SYNC_POLICY


def set_sync_policy(policy: SyncPolicy) -> SyncPolicy:
    """Install a new process-wide :class:`SyncPolicy`; returns the previous one."""
    global _SYNC_POLICY
    if not isinstance(policy, SyncPolicy):
        raise TPUMetricsUserError(f"set_sync_policy expects a SyncPolicy, got {type(policy).__name__}")
    previous = _SYNC_POLICY
    _SYNC_POLICY = policy
    return previous


class sync_policy:
    """Context manager form: ``with sync_policy(SyncPolicy(retries=2)): ...``"""

    def __init__(self, policy: SyncPolicy) -> None:
        self._policy = policy
        self._previous: Optional[SyncPolicy] = None

    def __enter__(self) -> SyncPolicy:
        self._previous = set_sync_policy(self._policy)
        return self._policy

    def __exit__(self, *exc_info: Any) -> None:
        assert self._previous is not None
        set_sync_policy(self._previous)


class SyncPeerLostError(RuntimeError):
    """A sync collective lost one or more peers.

    Raise this from a custom ``dist_sync_fn`` to hand the degraded merge
    whatever shards did arrive: ``survivors`` is a list of per-peer state dicts
    (local rank excluded; it always counts as a survivor) and
    ``survivor_counts`` the matching update counts. Not retried: a lost peer
    will not come back within a backoff window.
    """

    no_retry = True

    def __init__(
        self,
        message: str,
        survivors: Optional[List[Dict[str, Any]]] = None,
        survivor_counts: Optional[List[int]] = None,
    ) -> None:
        super().__init__(message)
        self.survivors = survivors or []
        self.survivor_counts = survivor_counts if survivor_counts is not None else [1] * len(self.survivors)
        if len(self.survivor_counts) != len(self.survivors):
            raise ValueError("survivor_counts must match survivors in length")


# The backoff jitter's own RNG, apart from the global ``random`` state.
_RETRY_RNG = random.Random()


def seed_retry_jitter(seed: Optional[int] = None) -> None:
    """Re-seed the backoff-jitter RNG; a fixed seed makes :func:`run_with_retries`'s sleeps reproducible."""
    _RETRY_RNG.seed(seed)


def _jittered(delay: float, jitter: float) -> float:
    """One bounded-jitter sleep draw: uniform in ``delay * [1-jitter, 1+jitter]``."""
    if not 0.0 <= jitter <= 1.0:
        raise TPUMetricsUserError(f"SyncPolicy.jitter must lie in [0, 1], got {jitter!r}")
    if not jitter or delay <= 0.0:
        return max(0.0, delay)
    return delay * (1.0 + jitter * (2.0 * _RETRY_RNG.random() - 1.0))


def run_with_retries(attempt: Callable[[], _T], label: str = "", policy: Optional[SyncPolicy] = None) -> _T:
    """Run ``attempt`` under the policy's retry, backoff and timeout envelope.

    Exceptions whose class sets ``no_retry = True`` (:class:`SyncPeerLostError`)
    and user errors propagate at once; anything else is retried with
    exponential, jittered backoff until the attempts or the time budget run out.
    Each retry records a ``sync_retry`` observe event.
    """
    policy = policy if policy is not None else _SYNC_POLICY
    deadline = (time.monotonic() + policy.timeout_s) if policy.timeout_s is not None else None
    delay = policy.backoff_s
    for attempt_no in range(policy.retries + 1):
        try:
            return attempt()
        except Exception as exc:
            sleep_s = _jittered(delay, policy.jitter)
            # the budget check takes the worst-case draw, so whether a retry fits never depends on the RNG
            worst = delay * (1.0 + policy.jitter) if delay > 0 else 0.0
            out_of_budget = deadline is not None and time.monotonic() + worst > deadline
            if (
                attempt_no == policy.retries
                or getattr(exc, "no_retry", False)
                or isinstance(exc, TPUMetricsUserError)
                or out_of_budget
            ):
                raise
            _observe.note_sync_retry(label, attempt_no + 1, exc)
            time.sleep(sleep_s)
            delay *= 2.0
    raise AssertionError("unreachable")  # pragma: no cover


# ------------------------------------------------------------------ reduction of per-rank values
def _as_reduction(fx: Any) -> Any:
    return _REDUCE_ALIASES[fx] if isinstance(fx, str) else fx


def reduce_gathered(values: Sequence[torch.Tensor], fx: Any) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Apply the reduction ``fx`` to the per-rank values of one state, in rank order.

    sum, min and max fold the stack elementwise; mean is the sum over the
    ranks divided by their number (an integer state's mean is float32, or the
    default float type for int64, as the JAX package's ``pmean`` gives); cat
    concatenates along the first dimension; ``None`` returns the stack
    ``(world, ...)``, or the list of per-rank values when their shapes differ;
    a custom callable gets the stack.
    """
    fx = _as_reduction(fx)
    if fx is dim_zero_cat:
        return dim_zero_cat(list(values))
    if fx is None:
        if len({tuple(v.shape) for v in values}) > 1:
            return list(values)
        return torch.stack(list(values))
    stack = torch.stack(list(values))
    if fx is dim_zero_sum:
        return stack.sum(0)
    if fx is dim_zero_mean:
        total = stack.sum(0)
        return total.to(_mean_dtype(stack.dtype)) / len(values)
    if fx is dim_zero_max:
        return stack.amax(0)
    if fx is dim_zero_min:
        return stack.amin(0)
    if callable(fx):
        return fx(stack)
    raise TypeError(f"Unsupported dist_reduce_fx: {fx!r}")


# ------------------------------------------------------------------ collectives over a process group
def _collective_device(group: Any, like: Optional[torch.Tensor] = None) -> torch.device:
    """Where a collective's helper tensors live: beside the state, or where the group's backend needs them."""
    if like is not None:
        return like.device
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
           torch.float16, torch.bfloat16, torch.float32, torch.float64)
_MAX_DIMS = 8


def _meta(t: torch.Tensor) -> List[int]:
    """[leading size, ndim, dtype code, trailing dims...] of one rank's tensor, padded to a fixed width."""
    if t.ndim > _MAX_DIMS or t.dtype not in _DTYPES:
        raise TPUMetricsUserError(f"Cannot sync a state of dtype {t.dtype} with {t.ndim} dimensions")
    trailing = list(t.shape[1:])
    lead = t.shape[0] if t.ndim else 1
    return [lead, t.ndim, _DTYPES.index(t.dtype)] + trailing + [0] * (_MAX_DIMS - 1 - len(trailing))


def _gather_many(tensors: List[torch.Tensor], group: Any = None, rec: Any = None) -> List[List[torch.Tensor]]:
    """All-gather each tensor from every rank of ``group``; their leading sizes may differ.

    One collective carries every tensor's size, dtype and trailing shape (and
    one host read settles them); then each tensor is padded to the largest
    leading size, gathered, and trimmed back per rank. A rank whose tensor is
    empty along the first dimension takes a non-empty peer's dtype and
    trailing shape, so that a rank that saw no data needs to know nothing of
    what the others hold. Bool tensors travel as uint8. With a recorder
    ``rec``, each tensor's gathered bytes (its padded copy from every rank)
    count as ``sync_bytes`` under ``state<i>``.
    """
    if not tensors:
        return []
    world = dist.get_world_size(group)
    device = _collective_device(group, tensors[0])
    meta = torch.tensor([_meta(t) for t in tensors], dtype=torch.int64, device=device)
    metas = [torch.empty_like(meta) for _ in range(world)]
    dist.all_gather(metas, meta, group=group)
    with _tracing.span("host_read", "gather_meta"):
        # hotlint: intentional-transfer: the one host read that settles every gathered size and dtype
        table = torch.stack(metas).tolist()  # [rank][state][field]
    _observe.note_explicit_transfer("gather_meta")
    out: List[List[torch.Tensor]] = []
    for i, t in enumerate(tensors):
        # every rank reads the same table, so every rank takes the same branch (or raises) below
        rows = [table[r][i] for r in range(world)]
        empty = [row[1] >= 1 and row[0] == 0 for row in rows]
        kinds = {(row[1], row[2], tuple(row[3 : 3 + max(row[1] - 1, 0)])) for row, e in zip(rows, empty) if not e}
        if len(kinds) > 1:
            raise TPUMetricsUserError(
                f"Cannot sync state {i}: the ranks hold tensors of different dtypes or trailing shapes"
                f" ({sorted(kinds)})"
            )
        if kinds and any(empty):
            ndim, code, trailing = next(iter(kinds))
            if ndim == 0:
                raise TPUMetricsUserError(f"Cannot sync state {i}: an empty rank cannot stand in for a 0-d state")
            if t.ndim >= 1 and t.shape[0] == 0:
                t = torch.zeros((0,) + trailing, dtype=_DTYPES[code], device=t.device)
        dtype = t.dtype
        carried = t.to(torch.uint8) if dtype == torch.bool else t
        if all(row[1] == 0 for row in rows):
            parts = [torch.empty(1, dtype=carried.dtype, device=carried.device) for _ in range(world)]
            dist.all_gather(parts, carried.reshape(1).contiguous(), group=group)
            if rec is not None:
                rec.add_count("sync_bytes", f"state{i}", carried.element_size() * world)
            out.append([p.reshape(()).to(dtype) for p in parts])
            continue
        sizes = [row[0] for row in rows]
        cap = max(sizes)
        padded, _ = pad_to_capacity(carried, cap)
        parts = [torch.empty_like(padded) for _ in range(world)]
        dist.all_gather(parts, padded.contiguous(), group=group)
        if rec is not None:
            rec.add_count("sync_bytes", f"state{i}", padded.numel() * padded.element_size() * world)
        out.append([p[:n].to(dtype) for p, n in zip(parts, sizes)])
    return out


def _concat_list_state(value: Any, device: torch.device) -> torch.Tensor:
    """A list state as one tensor (one collective); an empty list as a float32 zero-length placeholder."""
    if not isinstance(value, list):
        return value
    if value:
        return torch.cat([torch.atleast_1d(x) for x in value])
    return torch.zeros((0,), device=device)


def gather_all_states(states: List[Any], group: Any = None) -> List[List[Any]]:
    """Gather each state from every rank of ``group``: one list of per-rank tensors per state.

    The default ``dist_sync_fn`` of ``Metric.sync``. Without an initialized
    process group each state is its own only rank. List states are
    concatenated first; ragged leading sizes are padded to the largest, gathered
    and trimmed (the sizes travel on the states' device, since NCCL takes only
    CUDA tensors).
    """
    if not (dist.is_available() and dist.is_initialized()):
        return [[s] for s in states]
    rec = _observe.RECORDER if _observe.ENABLED else None
    world = str(dist.get_world_size(group))
    with _tracing.timed_span("gather_all", world) if rec is not None else _tracing.profiler_range("gather_all", world):
        device = _collective_device(group, next((s for s in states if isinstance(s, torch.Tensor)), None))
        out = _gather_many([_concat_list_state(s, device) for s in states], group, rec)
    if rec is not None:
        rec.add_count("gather_all", world)
    return out


_ALL_REDUCE_OPS = {dim_zero_sum: "SUM", dim_zero_max: "MAX", dim_zero_min: "MIN", dim_zero_mean: "SUM"}


def _all_reduce(value: torch.Tensor, fx: Any, group: Any) -> torch.Tensor:
    """sum, min, max and mean of one state over the group, on a copy (states are never changed in place)."""
    op = getattr(dist.ReduceOp, _ALL_REDUCE_OPS[fx])
    if value.dtype == torch.bool:
        # bools travel as uint8; their sum counts, as the JAX package's psum of a bool does
        work = value.to(torch.int64 if fx in (dim_zero_sum, dim_zero_mean) else torch.uint8)
    else:
        work = value.clone()
    work = work.contiguous()
    dist.all_reduce(work, op=op, group=group)
    if fx is dim_zero_mean:
        return work.to(_mean_dtype(work.dtype)) / dist.get_world_size(group)
    if value.dtype == torch.bool and fx is not dim_zero_sum:
        return work.to(torch.bool)
    return work


def _all_reduce_in_place(tensor: torch.Tensor, op: str, group: Any) -> torch.Tensor:
    """``tensor`` all-reduced over ``group`` by ``op`` (``"SUM"``, ``"MAX"`` or ``"MIN"``), in place: the sharded
    engine's cross-group stage, whose operands are fresh tensors of its own."""
    dist.all_reduce(tensor, op=getattr(dist.ReduceOp, op), group=group)
    return tensor


def sync_states(
    state: Dict[str, Any],
    reductions: Dict[str, Any],
    group: Any = None,
    associative: Optional[Dict[str, Optional[bool]]] = None,
) -> Dict[str, Any]:
    """Reduce a state dict across the ranks of ``group`` (the default group when ``None``).

    The counterpart of the JAX package's in-program mesh reduction, for the
    state dicts of :meth:`Metric.functional`. Every rank must call it with the
    same state names. ``associative`` carries each state's
    ``merge_associative`` flag: a custom reduction declared ``False`` is
    refused, since its gather-then-fold would depend on rank order.
    """
    associative = associative or {}
    out: Dict[str, Any] = {}
    gathered_names: List[str] = []
    device = _collective_device(group, next((v for v in state.values() if isinstance(v, torch.Tensor)), None))
    for name, value in state.items():
        fx = _as_reduction(reductions.get(name))
        if callable(fx) and fx not in _BUILTIN_REDUCTIONS and associative.get(name) is False:
            raise TPUMetricsUserError(
                f"State {name!r} has a custom dist_reduce_fx declared merge_associative=False: "
                "its cross-rank fold depends on rank order and cannot be synced. Reformulate "
                "the reduction as associative+commutative, or gather with dist_reduce_fx=None/'cat' "
                "and finish the order-sensitive fold on the host."
            )
        if fx in _ALL_REDUCE_OPS and not isinstance(value, list):
            out[name] = _all_reduce(value, fx, group)
        else:
            gathered_names.append(name)
    if gathered_names:
        per_rank = _gather_many([_concat_list_state(state[n], device) for n in gathered_names], group)
        for name, values in zip(gathered_names, per_rank):
            out[name] = reduce_gathered(values, reductions.get(name))
    return {name: out[name] for name in state}


# ------------------------------------------------------------------ N ranks' states in one process
def allreduce_over_mesh(per_rank_states: Sequence[Dict[str, Any]], reductions: Dict[str, Any]) -> Dict[str, Any]:
    """Fold N ranks' state dicts, held in one process on one device, into the synced state.

    The name is the JAX package's, whose version shards the stack over a
    device mesh and runs the collectives; here the N states are folded where
    they are, with no process group, by the same :func:`reduce_gathered` that
    :func:`sync_states` applies to what it gathers. The contracts are the JAX
    package's: list states are concatenated per rank first; a rank with an
    empty list takes a peer's dtype and trailing shape (float32 ``(0,)`` when
    every rank is empty); ragged ``cat`` states concatenate each rank's valid
    rows and ragged ``None`` states come back as the list of per-rank values;
    any other reduction over unequal per-rank sizes raises
    ``NotImplementedError``. With telemetry on, the fold is timed and counted
    under the JAX package's default mesh axis name, ``"data"``, and each
    state's stacked bytes (every rank at the largest leading size) count as
    ``sync_bytes``.
    """
    if _observe.ENABLED:
        with _tracing.timed_span("allreduce", "data"):
            out = _fold_ranks(per_rank_states, reductions, _observe.RECORDER)
        _observe.RECORDER.add_count("allreduce", "data")
        return out
    with _tracing.profiler_range("allreduce", "data"):
        return _fold_ranks(per_rank_states, reductions, None)


def _fold_ranks(per_rank_states: Sequence[Dict[str, Any]], reductions: Dict[str, Any], rec: Any) -> Dict[str, Any]:
    """The body of :func:`allreduce_over_mesh`; with a recorder ``rec``, each state's stacked bytes count."""
    prepped: List[Dict[str, Any]] = []
    empty_slots: List[Tuple[int, str]] = []
    for i, st in enumerate(per_rank_states):
        d: Dict[str, Any] = {}
        for k, v in st.items():
            if isinstance(v, list):
                if v:
                    d[k] = torch.cat([torch.atleast_1d(x) for x in v])
                else:
                    d[k] = None
                    empty_slots.append((i, k))
            else:
                d[k] = torch.as_tensor(v)
        prepped.append(d)
    for i, k in empty_slots:
        peer = next((p[k] for p in prepped if p[k] is not None), None)
        if peer is not None:
            prepped[i][k] = torch.zeros((0,) + tuple(peer.shape[1:]), dtype=peer.dtype, device=peer.device)
        else:
            prepped[i][k] = torch.zeros((0,))
    out: Dict[str, Any] = {}
    for k in prepped[0]:
        fx = _as_reduction(reductions.get(k))
        values = [p[k] for p in prepped]
        dims = [v.shape[0] if v.ndim else 0 for v in values]
        if len(set(dims)) > 1 and not (fx is None or fx is dim_zero_cat):
            raise NotImplementedError(
                f"State {k!r} has dist_reduce_fx={fx!r} with unequal per-rank sizes {dims}; "
                "non-concatenating reductions would consume pad rows inside the collective. Pad "
                "the per-rank states to a common capacity (pad_to_capacity) before calling "
                "allreduce_over_mesh."
            )
        out[k] = reduce_gathered(values, fx)
    if rec is not None:
        for k in prepped[0]:
            values = [p[k] for p in prepped]
            rec.add_count("sync_bytes", k, len(values) * max(v.numel() for v in values) * values[0].element_size())
    return out


def pad_to_capacity(
    x: torch.Tensor, capacity: int, axis: int = 0, fill_value: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad ``x`` to ``capacity`` along ``axis``; returns ``(padded, valid_count)`` (count int32)."""
    n = x.shape[axis]
    if n > capacity:
        raise ValueError(f"Buffer overflow: {n} > capacity {capacity}")
    pad_shape = list(x.shape)
    pad_shape[axis] = capacity - n
    pad = torch.full(pad_shape, fill_value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=axis), torch.tensor(n, dtype=torch.int32, device=x.device)
