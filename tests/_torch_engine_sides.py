"""One fleet-engine scenario, two packages: the harness of ``tests/test_torch_engine*.py``.

A test writes its scenario once against a :class:`Side` and runs it on the JAX
package (the reference) and on the port, with the same seeded numpy batches;
the sides then compare what each scenario returned: per-session states by
value (the port's counters are int64 where the JAX package's are int32),
computed values within a stated tolerance, counters by value.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator

import numpy as np
import torch

VALUE_RTOL = 1e-6  # computed values (a bucket-wide vmapped compute may reassociate float reductions)


class Side:
    """One package's engine, metrics and helpers under one interface."""

    def __init__(self, name: str) -> None:
        self.name = name
        if name == "jax":
            import jax.numpy as jnp

            import metrics_tpu as pkg
            import metrics_tpu.engine.core as core
            import metrics_tpu.engine.durability as durability
            import metrics_tpu.engine.sharded as sharded
            import metrics_tpu.resilience.checkpoint as checkpoint
            from metrics_tpu import observe
            from metrics_tpu.classification import BinaryAUROC, MulticlassAccuracy
            from metrics_tpu.metric import Metric
            from metrics_tpu.utils.checks import _is_traced
            from metrics_tpu.utils.exceptions import TPUMetricsUserError, TraceIneligibleError

            self.xp = jnp
            self.kw: Dict[str, Any] = {}
        else:
            import metrics_tpu_torch as pkg
            import metrics_tpu_torch.engine.core as core
            import metrics_tpu_torch.engine.durability as durability
            import metrics_tpu_torch.engine.sharded as sharded
            import metrics_tpu_torch.resilience.checkpoint as checkpoint
            from metrics_tpu_torch import observe
            from metrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy
            from metrics_tpu_torch.metric import Metric
            from metrics_tpu_torch.utils.checks import _is_traced
            from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError, TraceIneligibleError

            self.xp = torch
            self.kw = {"device": "cpu"}
        self.pkg, self.core, self.durability, self.sharded, self.checkpoint = pkg, core, durability, sharded, checkpoint
        self.observe, self.Metric = observe, Metric
        self.StreamEngine, self.ShardedStreamEngine = pkg.StreamEngine, pkg.ShardedStreamEngine
        self.BinaryAUROC, self.MulticlassAccuracy = BinaryAUROC, MulticlassAccuracy
        self.is_traced, self.UserError, self.TraceIneligibleError = _is_traced, TPUMetricsUserError, TraceIneligibleError
        self._classes = _custom_classes(self)

    # ---------------------------------------------------------------- arrays
    def arr(self, x: Any) -> Any:
        x = np.asarray(x)
        if self.name == "jax":
            return self.xp.asarray(x)
        return torch.from_numpy(np.array(x))

    def np(self, x: Any) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def tree_np(self, x: Any) -> Any:
        if isinstance(x, dict):
            return {k: self.tree_np(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self.tree_np(v) for v in x)
        return self.np(x)

    # ---------------------------------------------------------------- metrics
    def acc(self, **kw: Any) -> Any:
        return self.MulticlassAccuracy(num_classes=4, **kw, **self.kw)

    def acc_batch(self, rng: np.random.RandomState, n: int = 8):
        return self.arr(rng.randint(4, size=n)), self.arr(rng.randint(4, size=n))

    def auroc(self) -> Any:
        return self.BinaryAUROC(thresholds=8, **self.kw)

    def auroc_batch(self, rng: np.random.RandomState, n: int = 8):
        return self.arr(rng.rand(n).astype(np.float32)), self.arr(rng.randint(2, size=n))

    def custom(self, name: str, **kw: Any) -> Any:
        return self._classes[name](**kw, **self.kw)

    # ---------------------------------------------------------------- engine views
    def rows(self, engine: Any, sid: Any) -> Dict[str, np.ndarray]:
        sess = engine._sessions[sid]
        if sess.bucket is None:
            return {k: self.np(v) for k, v in sess.metric._state.items()}
        return {k: self.np(v[sess.slot]) for k, v in sess.bucket.stacked.items()}

    def oracle_state(self, metric: Any) -> Dict[str, np.ndarray]:
        return {k: self.np(v) for k, v in metric._state.items()}

    def assert_rows(self, engine: Any, sid: Any, oracle: Any) -> None:
        row = self.rows(engine, sid)
        for k, ref in self.oracle_state(oracle).items():
            np.testing.assert_array_equal(row[k], ref, err_msg=f"{self.name}: state {k!r}")

    def counters(self) -> Dict[str, Dict[str, int]]:
        return self.observe.snapshot()["counters"]

    def count(self, name: str) -> int:
        return int(sum(self.counters().get(name, {}).values()))

    def update_compiles(self) -> Dict[str, int]:
        return {k: v for k, v in self.counters().get("fleet_compile", {}).items() if not k.endswith(":compute")}

    def clear_cache(self) -> None:
        if self.name == "jax":
            from metrics_tpu.metric import clear_jit_cache

            clear_jit_cache()
        else:
            self.core._FLEET_JIT_CACHE.clear()
            self.core._REPLICA_JIT_CACHE.clear()

    @contextlib.contextmanager
    def fresh(self) -> Iterator["Side"]:
        """Empty program caches and telemetry on, reset, for one scenario."""
        self.clear_cache()
        if self.name == "jax":
            from metrics_tpu.metric import jit_update_enabled

            jit_update_enabled(True)
        with self.observe.scope(reset=True):
            yield self
        self.clear_cache()


def _custom_classes(side: Side) -> Dict[str, type]:
    """The JAX package's test metrics, written once per package."""
    xp, Metric = side.xp, side.Metric
    as_f32 = (lambda x: xp.asarray(x, dtype=xp.float32)) if side.name == "jax" else (
        lambda x: torch.as_tensor(np.asarray(x) if isinstance(x, list) else x, dtype=torch.float32))
    zero = (lambda: xp.asarray(0.0)) if side.name == "jax" else (lambda: torch.tensor(0.0))
    host_max = (lambda x: float(np.max(np.asarray(x)))) if side.name == "jax" else (lambda x: float(x.max()))
    is_traced, TIE = side.is_traced, side.TraceIneligibleError

    class RunningMax(Metric):
        """Bucketable, but its merge algebra is max: not fold-eligible, so polls ride the cached recompute."""

        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("peak", zero(), dist_reduce_fx="max")

        def update(self, x):
            self.peak = xp.maximum(self.peak, xp.max(as_f32(x)))

        def compute(self):
            return self.peak

    class AnySum(Metric):
        """Accepts any array-like, including Python lists, which cannot ride a bucket."""

        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", zero(), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + xp.sum(as_f32(x))

        def compute(self):
            return self.total

    class HostOnlyUpdate(Metric):
        """Batchable signature, unbatchable body: demotes its bucket at first flush."""

        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("peak", zero(), dist_reduce_fx="max")

        def update(self, x):
            if is_traced(x):
                raise TIE("needs concrete data")
            self.peak = xp.maximum(self.peak, xp.asarray(host_max(x)) if side.name == "jax" else torch.tensor(host_max(x)))

        def compute(self):
            return self.peak

    class HostOnlyCompute(Metric):
        """Batchable update, unbatchable compute: buckets fine, computes per row."""

        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", zero(), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + xp.sum(x)

        def compute(self):
            if is_traced(self.total):
                raise TIE("host-side compute")
            return self.total

    return {"RunningMax": RunningMax, "AnySum": AnySum, "HostOnlyUpdate": HostOnlyUpdate,
            "HostOnlyCompute": HostOnlyCompute}


_SIDES: Dict[str, Side] = {}


def side(name: str) -> Side:
    if name not in _SIDES:
        _SIDES[name] = Side(name)
    return _SIDES[name]


def both(scenario, *args: Any, **kwargs: Any):
    """Run ``scenario(side, ...)`` on the JAX package, then on the port; returns both results."""
    out = []
    for name in ("jax", "torch"):
        s = side(name)
        with s.fresh():
            out.append(scenario(s, *args, **kwargs))
    return out[0], out[1]


def assert_same(ref: Any, port: Any, rtol: float = 0.0, path: str = "") -> None:
    """Equal results: numbers and arrays by value (``rtol`` for floats), containers element by element."""
    if isinstance(ref, dict):
        assert set(ref) == set(port), f"{path}: keys {sorted(map(str, ref))} vs {sorted(map(str, port))}"
        for k in ref:
            assert_same(ref[k], port[k], rtol, f"{path}.{k}")
        return
    if isinstance(ref, (list, tuple)):
        assert len(ref) == len(port), f"{path}: lengths {len(ref)} vs {len(port)}"
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same(a, b, rtol, f"{path}[{i}]")
        return
    if isinstance(ref, (str, bool, type(None))):
        assert ref == port, f"{path}: {ref!r} vs {port!r}"
        return
    a, b = np.asarray(ref), np.asarray(port)
    assert a.shape == b.shape, f"{path}: shapes {a.shape} vs {b.shape}"
    if rtol and (a.dtype.kind == "f" or b.dtype.kind == "f"):
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), rtol=rtol, atol=0, err_msg=path)
    else:
        np.testing.assert_array_equal(b, a, err_msg=path)
