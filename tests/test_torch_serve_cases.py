"""One front-door scenario, two packages: the shared harness of ``tests/test_torch_serve*.py``.

A scenario is written once against a :class:`ServeSide` and runs on the JAX
package (the reference) and on the port (on the CPU), with the same seeded
numpy batches. Each side asserts what the JAX package's own serve tests assert,
and the scenario returns what the two sides must agree on: acks, watermarks,
counters and per-session states by value (the port's counters are int64 where
the JAX package's are int32, so states compare by value, never by digest).
"""

from __future__ import annotations

import importlib
import socket
from typing import Any, Callable, Dict, Tuple

import numpy as np

from _torch_engine_sides import side

KEY = "test-key"


class ServeSide:
    """One package's serve modules, engines and metrics under one interface."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.s = side(name)
        pkg = "metrics_tpu" if name == "jax" else "metrics_tpu_torch"
        self.protocol = importlib.import_module(f"{pkg}.serve.protocol")
        self.server_mod = importlib.import_module(f"{pkg}.serve.server")
        self.admission = importlib.import_module(f"{pkg}.serve.admission")
        self.autonomic = importlib.import_module(f"{pkg}.serve.autonomic")
        self.smoke = importlib.import_module(f"{pkg}.serve.smoke")
        self.serve = importlib.import_module(f"{pkg}.serve")
        self.metering = importlib.import_module(f"{pkg}.observe.metering")
        self.durability = self.s.durability
        self.observe = self.s.observe
        self.Producer = self.protocol.Producer
        self.encode_frame = self.protocol.encode_frame
        self.WAL_MAGIC = self.protocol.WAL_MAGIC
        self.AdmissionController = self.admission.AdmissionController
        self.AdmissionRule = self.admission.AdmissionRule
        self.AutonomicController = self.autonomic.AutonomicController
        self.cpu = {} if name == "jax" else {"device": "cpu"}

    # ---------------------------------------------------------------- fleet
    def metric(self, num_classes: int = 4) -> Any:
        return self.s.MulticlassAccuracy(num_classes=num_classes, validate_args=False, **self.s.kw)

    def engine(self, **kw: Any) -> Any:
        return self.s.StreamEngine(**kw)

    def fleet(self, n_shards: int, **kw: Any) -> Any:
        if self.name == "torch":
            kw["devices"] = ["cpu"]
        return self.s.ShardedStreamEngine(n_shards=n_shards, **kw)

    def server(self, engine: Any, key: str = KEY, **kw: Any) -> Any:
        if self.name == "torch" and getattr(engine, "_shards", None) is None:
            kw.setdefault("device", "cpu")
        return self.server_mod.MetricsServer(engine, key, **kw)

    def rig(self, tmp_path: Any, engine: Any = None, name: str = "prod-a", **kw: Any) -> Tuple[Any, Any, Any]:
        """Listener-less server, an adopted socketpair and an in-process Producer."""
        if engine is None:
            engine = self.engine(wal_path=str(tmp_path / "serve.wal"))
        server = self.server(engine, host=None, **kw)
        srv_sock, cli_sock = socket.socketpair()
        server.adopt(srv_sock)
        prod = self.Producer(None, KEY, name=name, sock=cli_sock, drive=lambda: server.poll(0.0))
        return engine, server, prod

    def applied(self, engine: Any, sid: Any) -> int:
        sess = engine._sessions[sid]
        return sess.base_count + sess.engine_count

    def state(self, engine: Any, sid: Any) -> Dict[str, np.ndarray]:
        return self.s.rows(engine, sid)


_SIDES: Dict[str, ServeSide] = {}


def serve_side(name: str) -> ServeSide:
    if name not in _SIDES:
        _SIDES[name] = ServeSide(name)
    return _SIDES[name]


def batch(seed: int = 0, n: int = 8, classes: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return rng.integers(0, classes, n), rng.integers(0, classes, n)


def on_both(scenario: Callable[..., Any], tmp_path: Any, *args: Any, **kwargs: Any) -> Tuple[Any, Any]:
    """Run ``scenario(serve_side, tmp_dir, ...)`` on the JAX package, then on the port, each with empty program
    caches, telemetry on and reset, and a directory of its own; returns both results."""
    out = []
    for name in ("jax", "torch"):
        sv = serve_side(name)
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        with sv.s.fresh():
            out.append(scenario(sv, d, *args, **kwargs))
    return out[0], out[1]


def same(a: Any, b: Any) -> bool:
    """Structural equality that treats ndarrays by value and dtype (== would vectorize)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(same(v, b[k]) for k, v in a.items())
    return type(a) is type(b) and a == b
