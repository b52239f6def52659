"""Worker processes for tests/test_torch_sync_gloo.py: the port's sync over real gloo process groups.

Each worker joins a gloo group of ``world`` processes through a ``file://``
store, runs every case in :data:`CASES` in the same order as its peers, and
writes ``{case: "ok" or the traceback}`` to ``<out_dir>/<rank>.pkl``. Each case
holds the synced result against the single-stream run: every rank rebuilds
every rank's seeded inputs, so it can run the whole stream through one metric
itself. Integer states must be equal, float states and scores within rtol
1e-5, Pearson and Spearman within rtol 1e-4.

The states live on ``device``: the CPU for the gloo tests here, a CUDA
device for ``tests/test_torch_cuda.py``, whose two ranks share the one card
(gloo moves CUDA tensors itself; NCCL takes one rank per device). This module
imports neither JAX nor the JAX package, so that the spawned processes start
fast and run where JAX is not installed.
"""

from __future__ import annotations

import pickle
import traceback
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

import metrics_tpu_torch.classification as tc
from metrics_tpu_torch import CatMetric, MaxMetric, MeanMetric, MetricCollection, MinMetric, SumMetric
from metrics_tpu_torch.parallel import gather_all_states, sync_states
from metrics_tpu_torch.regression import MeanSquaredError, PearsonCorrCoef, SpearmanCorrCoef
from metrics_tpu_torch.retrieval import RetrievalMAP
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

RTOL, CORR_RTOL = 1e-5, 1e-4
CLASSES = 7
DEVICE = torch.device("cpu")  # set by run()


def _rows(rank: int) -> int:
    return 24 + 9 * rank  # unequal shards


def _shard(rank: int) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(1000 + rank)
    n = _rows(rank)
    target = rng.randn(n).astype(np.float32)
    return {
        "logits": rng.randn(n, CLASSES).astype(np.float32),
        "labels": rng.randint(0, CLASSES, n),
        "x": (0.7 * target + 0.5 * rng.randn(n)).astype(np.float32),
        "y": target,
        "groups": rng.randint(0, 3, n),
        "binary": rng.randint(0, 2, n),
    }


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x)).to(DEVICE)


def _close(got, want, rtol=RTOL, name="") -> None:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    if got.shape != want.shape or not torch.allclose(got, want, rtol=rtol, atol=0.0):
        raise AssertionError(f"{name}: {got} != {want} (rtol {rtol})")


def _flat(value) -> torch.Tensor:
    """A list state as one tensor (a synced cat state is one tensor already)."""
    return torch.cat(value) if isinstance(value, list) else value


def _equal(got, want, name="") -> None:
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: {got} ({got.dtype}) != {want} ({want.dtype})")


# ----------------------------------------------------------------------------- cases
def case_reduction_kinds(rank: int, world: int) -> None:
    """sync_states: every reduction kind, over float, int64 and bool states."""
    def state_of(r: int) -> Dict[str, torch.Tensor]:
        g = torch.Generator().manual_seed(r)
        return {k: v.to(DEVICE) for k, v in {
            "sum_f": torch.rand(3, generator=g),
            "sum_i": torch.arange(4, dtype=torch.int64) * (r + 1),
            "mean_f": torch.rand(2, generator=g),
            "mean_i": torch.tensor(r + 2, dtype=torch.int64),
            "max_f": torch.rand(3, generator=g),
            "min_f": torch.rand(3, generator=g),
            "max_b": torch.tensor([r == 0, False, True]),
            "cat_f": torch.rand(r + 1, generator=g),
            "none_f": torch.rand(2, generator=g),
            "custom": torch.rand(2, generator=g),
        }.items()}

    reductions = {"sum_f": "sum", "sum_i": "sum", "mean_f": "mean", "mean_i": "mean", "max_f": "max", "min_f": "min",
                  "max_b": "max", "cat_f": "cat", "none_f": None, "custom": lambda stack: stack.abs().amax(0)}
    out = sync_states(state_of(rank), reductions, associative={"custom": True})
    every = [state_of(r) for r in range(world)]
    stack = {k: [s[k] for s in every] for k in every[0]}
    _close(out["sum_f"], torch.stack(stack["sum_f"]).sum(0), name="sum_f")
    _equal(out["sum_i"], torch.stack(stack["sum_i"]).sum(0), name="sum_i")
    _close(out["mean_f"], torch.stack(stack["mean_f"]).sum(0) / world, name="mean_f")
    # an int64 state's mean takes the default float type, as jnp.mean of int64 does under x64
    _equal(out["mean_i"], torch.stack(stack["mean_i"]).sum(0).to(torch.get_default_dtype()) / world, name="mean_i")
    _equal(out["max_f"], torch.stack(stack["max_f"]).amax(0), name="max_f")
    _equal(out["min_f"], torch.stack(stack["min_f"]).amin(0), name="min_f")
    _equal(out["max_b"], torch.stack(stack["max_b"]).amax(0), name="max_b")
    _equal(out["cat_f"], torch.cat(stack["cat_f"]), name="cat_f")
    _equal(out["none_f"], torch.stack(stack["none_f"]), name="none_f")
    _equal(out["custom"], torch.stack(stack["custom"]).abs().amax(0), name="custom")
    try:
        sync_states({"custom": torch.zeros(2, device=DEVICE)}, {"custom": lambda s: s[0]},
                    associative={"custom": False})
    except TPUMetricsUserError:
        pass
    else:
        raise AssertionError("a non-associative custom reduction was synced")


def case_gather_bool_int64_and_ragged(rank: int, world: int) -> None:
    """gather_all_states: bool and int64 states keep their types; ragged leading sizes come back trimmed."""
    def states_of(r):
        return [torch.arange(r + 2, dtype=torch.int64, device=DEVICE), torch.tensor([True] * (r + 1), device=DEVICE),
                torch.tensor(float(r), device=DEVICE),
                [torch.ones(2, 3, device=DEVICE) * r, torch.ones(1, 3, device=DEVICE)]]

    gathered = gather_all_states(states_of(rank), None)
    for r in range(world):
        want = states_of(r)
        for i, name in enumerate(["int64", "bool", "0-d"]):
            _equal(gathered[i][r], want[i], name=name)
        _equal(gathered[3][r], torch.cat(want[3]), name="list")


def _stream_and_local(make: Callable, feed: Callable, rank: int, world: int):
    """(a metric fed this rank's shard, a metric fed every shard in rank order that never syncs)."""
    local, whole = make(), make(sync_on_compute=False)
    feed(local, _shard(rank))
    for r in range(world):
        feed(whole, _shard(r))
    return local, whole


def case_ragged_cat_metric_sync(rank: int, world: int) -> None:
    """Metric.sync of ragged cat states (CatMetric, Spearman), then unsync brings back the local ones."""
    for make, feed, rtol in [
        (lambda **kw: CatMetric(**kw, device=DEVICE), lambda m, s: m.update(_t(s["x"])), 0.0),
        (lambda **kw: SpearmanCorrCoef(**kw, device=DEVICE), lambda m, s: m.update(_t(s["x"]), _t(s["y"])), CORR_RTOL),
    ]:
        local, whole = _stream_and_local(make, feed, rank, world)
        before = {k: _flat(v) for k, v in local.metric_state.items()}
        local.sync()
        for key, value in local.metric_state.items():
            _equal(_flat(value), _flat(whole.metric_state[key]), name=f"{type(local).__name__}.{key}")
        local.unsync()
        for key, value in local.metric_state.items():
            _equal(_flat(value), before[key], name=f"{type(local).__name__}.{key} after unsync")
        got, want = local.compute(), whole.compute()  # compute syncs again inside
        if rtol:
            _close(got, want, rtol, type(local).__name__)
        else:
            _equal(got, want, type(local).__name__)


def case_empty_rank(rank: int, world: int) -> None:
    """Rank 0 saw no data: its empty list states take the peers' dtype and shape."""
    for make, feed in [
        (lambda **kw: CatMetric(**kw, device=DEVICE), lambda m, s: m.update(_t(s["x"]))),
        (lambda **kw: SpearmanCorrCoef(**kw, device=DEVICE), lambda m, s: m.update(_t(s["x"]), _t(s["y"]))),
    ]:
        local, whole = make(), make(sync_on_compute=False)
        if rank != 0:
            feed(local, _shard(rank))
        for r in range(1, world):
            feed(whole, _shard(r))
        got, want = local.compute(), whole.compute()
        if isinstance(local, CatMetric):
            _equal(got, want, "CatMetric")
        else:
            _close(got, want, CORR_RTOL, "SpearmanCorrCoef")


def case_every_state_kind_through_metric_sync(rank: int, world: int) -> None:
    """Metric.sync of sum (MSE, Mean), max, min, int64 sum (accuracy, fairness) and Pearson's None states."""
    runs = [
        (lambda **kw: MeanSquaredError(**kw, device=DEVICE), lambda m, s: m.update(_t(s["x"]), _t(s["y"])), RTOL),
        (lambda **kw: MeanMetric(**kw, device=DEVICE), lambda m, s: m.update(_t(s["x"]), _t(np.abs(s["y"]))), RTOL),
        (lambda **kw: SumMetric(**kw, device=DEVICE), lambda m, s: m.update(_t(s["x"])), RTOL),
        (lambda **kw: MaxMetric(**kw, device=DEVICE), lambda m, s: m.update(_t(s["x"])), 0.0),
        (lambda **kw: MinMetric(**kw, device=DEVICE), lambda m, s: m.update(_t(s["x"])), 0.0),
        (lambda **kw: PearsonCorrCoef(**kw, device=DEVICE), lambda m, s: m.update(_t(s["x"]), _t(s["y"])), CORR_RTOL),
        (lambda **kw: tc.MulticlassAccuracy(**kw, num_classes=CLASSES, device=DEVICE),
         lambda m, s: m.update(_t(s["logits"]), _t(s["labels"])), 0.0),
        (lambda **kw: tc.BinaryFairness(**kw, num_groups=3, device=DEVICE),
         lambda m, s: m.update(_t(1 / (1 + np.exp(-s["x"]))), _t(s["binary"]), _t(s["groups"])), RTOL),
    ]
    for make, feed, rtol in runs:
        local, whole = _stream_and_local(make, feed, rank, world)
        name = type(local).__name__
        local_states = dict(local.metric_state)
        local.sync()
        if isinstance(local, PearsonCorrCoef):
            # None states come back one replica deep: (world,) + the state's shape
            for key, value in local.metric_state.items():
                if value.shape != (world,):
                    raise AssertionError(f"{name}.{key}: shape {tuple(value.shape)}")
        else:
            for key, value in local.metric_state.items():
                want = whole.metric_state[key]
                _equal(value, want, f"{name}.{key}") if not value.is_floating_point() else _close(
                    value, want, RTOL, f"{name}.{key}")
        local.unsync()
        for key, value in local.metric_state.items():
            if value is not local_states[key]:
                raise AssertionError(f"{name}.{key}: unsync did not bring back the local state")
        got, want = local.compute(), whole.compute()
        for g, w in (zip(got.values(), want.values()) if isinstance(got, dict) else [(got, want)]):
            _close(g, w, rtol, name) if rtol else _equal(g, w, name)


def _eval_collection(**kw) -> MetricCollection:
    return MetricCollection([tc.MulticlassAccuracy(num_classes=CLASSES, average="micro", device=DEVICE, **kw),
                             tc.MulticlassPrecision(num_classes=CLASSES, device=DEVICE, **kw),
                             tc.MulticlassRecall(num_classes=CLASSES, device=DEVICE, **kw),
                             tc.MulticlassF1Score(num_classes=CLASSES, average="macro", device=DEVICE, **kw),
                             tc.MulticlassConfusionMatrix(num_classes=CLASSES, device=DEVICE, **kw)])


def case_collection_compute(rank: int, world: int) -> None:
    """A collection's compute() syncs each member over the group and equals the single-stream run."""
    local, whole = _stream_and_local(_eval_collection, lambda m, s: m.update(_t(s["logits"]), _t(s["labels"])),
                                     rank, world)
    if local.compute_groups != whole.compute_groups:
        raise AssertionError(f"groups {local.compute_groups} != {whole.compute_groups}")
    got, want = local.compute(), whole.compute()
    for key in want:
        _equal(got[key], want[key], key) if not want[key].is_floating_point() else _close(got[key], want[key],
                                                                                          RTOL, key)
    # the members' own states are local again after compute
    if int(local["MulticlassConfusionMatrix"].confmat.sum()) != _rows(rank):
        raise AssertionError("the confusion matrix was left synced")


def case_collection_functional_sync(rank: int, world: int) -> None:
    """CollectionFunctions.sync over the group, then compute, equals the single-stream run."""
    local, whole = _eval_collection(), _eval_collection(sync_on_compute=False)
    fns = local.functional()
    state = fns.init()
    s = _shard(rank)
    state = fns.update(state, _t(s["logits"]), _t(s["labels"]))
    for r in range(world):
        whole.update(_t(_shard(r)["logits"]), _t(_shard(r)["labels"]))
    got, want = fns.compute(fns.sync(state)), whole.compute()
    for key in want:
        _close(got[key], want[key], RTOL, key)


def case_sync_on_step_forward(rank: int, world: int) -> None:
    """dist_sync_on_step: forward returns the batch value over every rank's batch."""
    local = SumMetric(device=DEVICE, dist_sync_on_step=True)
    batch = local(_t(_shard(rank)["x"]))
    want = sum(float(np.sum(_shard(r)["x"].astype(np.float64))) for r in range(world))
    _close(batch.cpu(), torch.tensor(want), RTOL, "forward")
    _close(local.sum_value.cpu(), torch.tensor(float(np.sum(_shard(rank)["x"].astype(np.float64)))), RTOL,
           "local state")


def case_subgroup_sync_over_data_rows(rank: int, world: int) -> None:
    """A (model, data) layout of the world, one ``dist.new_group`` per data row: each rank's compute() syncs
    over its own row only and equals the single stream over that row's shards (the model axis replicates
    the batch, the data axis splits it)."""
    model = 2 if world % 2 == 0 else 1
    data = world // model
    rows = [dist.new_group(list(range(m * data, (m + 1) * data)), backend="gloo") for m in range(model)]
    row, d = divmod(rank, data)
    try:
        make = lambda **kw: tc.MulticlassAccuracy(num_classes=CLASSES, average="micro", device=DEVICE, **kw)  # noqa: E731
        local, whole = make(process_group=rows[row]), make(sync_on_compute=False)
        feed = lambda m, s: m.update(_t(s["logits"]), _t(s["labels"]))  # noqa: E731
        feed(local, _shard(d))
        for dd in range(data):
            feed(whole, _shard(dd))
        _equal(local.compute(), whole.compute(), "row accuracy")
        if data > 1:  # a row of one rank does not sync
            local.sync()
            for key, value in local.metric_state.items():
                _equal(value, whole.metric_state[key], f"row state {key}")
            local.unsync()
    finally:
        for group in rows:
            dist.destroy_process_group(group)


def case_retrieval_list_states_sync(rank: int, world: int) -> None:
    """Retrieval's list states, gathered without a reduction, come back as one tensor per rank, and the
    synced score equals the single stream's."""
    make = lambda **kw: RetrievalMAP(device=DEVICE, **kw)  # noqa: E731
    feed = lambda m, s: m.update(_t(s["x"]), _t(s["binary"]), indexes=_t(s["groups"]))  # noqa: E731
    local, whole = _stream_and_local(make, feed, rank, world)
    local.sync()
    assert len(local.indexes) == world, len(local.indexes)
    for key in ("indexes", "preds", "target"):
        _equal(torch.cat(local.metric_state[key]), torch.cat(whole.metric_state[key]), key)
    local.unsync()
    _close(local.compute().cpu(), whole.compute().cpu(), RTOL, "RetrievalMAP")


def case_compute_sync_and_gather_are_ranges_and_nested_spans(rank: int, world: int) -> None:
    """Under the profiler with the recorder off, a compute()'s sync, its ``gather_all`` and the gather's size
    read are ranges of the capture; with the recorder on they are spans, each inside the one before, and the
    gather keeps its ``gather_all`` timer."""
    from metrics_tpu_torch import observe

    metric = SumMetric(device=DEVICE)
    metric.update(_t(np.arange(3.0 + rank)))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        metric.compute()
    names = {e.name for e in prof.events()}
    expected = {"compute:SumMetric", "sync:SumMetric", f"gather_all:{world}", "host_read:gather_meta"}
    if not expected <= names:
        raise AssertionError(f"missing ranges {sorted(expected - names)}")
    if observe.snapshot()["counters"]:
        raise AssertionError("the recorder counted while off")
    metric = SumMetric(device=DEVICE)
    metric.update(_t(np.arange(3.0 + rank)))
    observe.enable(reset=True)
    try:
        metric.compute()
        spans = {s["id"]: s for s in observe.drain_spans()}
        timers = observe.snapshot()["timers"]
    finally:
        observe.disable()
        observe.reset()
    [gather] = [s for s in spans.values() if s["phase"] == "gather_all"]
    [read] = [s for s in spans.values() if s["phase"] == "host_read"]
    sync = spans[gather["parent"]]
    chain = [read["phase"], spans[read["parent"]]["phase"], sync["phase"], spans[sync["parent"]]["phase"]]
    if chain != ["host_read", "gather_all", "sync", "compute"] or spans[sync["parent"]]["parent"] is not None:
        raise AssertionError(f"nesting {chain}")
    if timers["gather_all"][str(world)]["count"] != 1:
        raise AssertionError(f"gather_all timer {timers['gather_all']}")


CASES: Dict[str, Callable[[int, int], None]] = {
    name[len("case_"):]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")
}


def run(rank: int, world: int, store: str, out_dir: str, device: str = "cpu") -> None:
    """One rank: join a gloo group, run every case with its states on ``device``, write the outcomes."""
    global DEVICE
    DEVICE = torch.device(device)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    results: Dict[str, str] = {}
    try:
        for name, case in CASES.items():
            try:
                case(rank, world)
                results[name] = "ok"
            except Exception:  # noqa: BLE001 (the outcome goes back to the test)
                results[name] = traceback.format_exc()
            dist.barrier()
    finally:
        dist.destroy_process_group()
        with open(f"{out_dir}/{rank}.pkl", "wb") as fh:
            pickle.dump(results, fh)


def case_names() -> List[str]:
    return list(CASES)
