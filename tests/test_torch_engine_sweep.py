"""Every class of the JAX package's fleet registry (``analysis/fleet_contracts.fleet_cases``, 65 classes)
through a churning 4-slot bucket of the port's StreamEngine, and of the JAX package's.

The port's counterpart of the JAX package's ``check_fleet_case``: three
sessions and a padded virgin row, two full ticks, a tick with one session
idle (its row and the virgin row must come through the masked dispatch
bit-identical), an expiry mid-stream into a recycled slot, a fourth tick;
then every live state bit-identical to a per-instance oracle fed the same
batches (the JAX case's own batch function, same seed), computes within
rtol 1e-5 / atol 1e-7 (the JAX harness's tolerance), a checkpoint round trip
bit-exact, and a merge of two expired sessions equal to the oracles' merge
(the four classes with ``full_state_update=True`` refuse the merge in both
packages, and must refuse it here too). Each class must ride its bucket the
whole way: no session runs loose.

The JAX package's engine runs the same lifecycle on the same batches; the
port's live states equal its states by value (integer states exactly, float
states within the same tolerance) and the port's computes, the retiree's and
the merged one agree with its computes within that tolerance. SSIM is held at
the atol 1e-5 of ``tests/test_torch_image.py``: its float32 epilogue rounds
differently in the two frameworks.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest
import torch

from _torch_engine_cases import PORT_CTORS, to_torch

_RTOL, _ATOL = 1e-5, 1e-7


def _cases():
    from metrics_tpu.analysis.fleet_contracts import fleet_cases

    return fleet_cases()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(value):
    if isinstance(value, dict):
        return [leaf for k in sorted(value) for leaf in _leaves(value[k])]
    if isinstance(value, (list, tuple)):
        return [leaf for v in value for leaf in _leaves(v)]
    return [value]


def _close(a, b, what, rtol=_RTOL, atol=_ATOL):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        np.testing.assert_allclose(_np(x), _np(y), rtol=rtol, atol=atol, equal_nan=True, err_msg=what)


def _row(engine, sid):
    sess = engine._sessions[sid]
    if sess.bucket is None:
        return {k: _np(v) for k, v in sess.metric._state.items()}
    return {k: _np(v[sess.slot]) for k, v in sess.bucket.stacked.items()}


def _equal_rows(got, want, what):
    for k, ref in want.items():
        np.testing.assert_array_equal(got[k], ref, err_msg=f"{what}: state {k!r}")


_CASES = _cases()


def test_the_sweep_covers_the_registry():
    assert len(_CASES) == 65 and sorted(c.name for c in _CASES) == sorted(PORT_CTORS)


# the port against the JAX package, where the repo's parity tests state another tolerance
_CROSS_TOL = {"StructuralSimilarityIndexMeasure": (0.0, 1e-5)}  # tests/test_torch_image.py's ATOL

# full_state_update=True: merge_state raises in both packages
_NO_MERGE = {"PearsonCorrCoef", "ConcordanceCorrCoef", "MaxMetric", "MinMetric"}


def _batches(case):
    """The 11 batches of the lifecycle (3 + 3 + 2 + 3 submissions), in the order the ticks take them."""
    from metrics_tpu.observe.costs import _rng

    rng = _rng(case)
    return [case.batch(rng) for _ in range(11)]


def _jax_lifecycle(case, batches):
    """The same lifecycle through the JAX package's engine: live rows, computes, the retiree's, the merged one."""
    from _torch_engine_sides import side

    s = side("jax")
    feed_batches = iter(batches)
    with s.fresh():
        engine = s.StreamEngine(initial_capacity=4)
        sids = [engine.add_session(case.ctor()) for _ in range(3)]

        def feed(active):
            for sid in active:
                engine.submit(sid, *next(feed_batches))
            engine.tick()

        feed(sids)
        feed(sids)
        feed([sids[0], sids[2]])
        retired = engine.expire(sids[1])
        replacement = engine.add_session(case.ctor())
        live = [sids[0], sids[2], replacement]
        feed(live)
        out = {"rows": [s.rows(engine, sid) for sid in live],
               "values": [s.tree_np(engine.compute(sid)) for sid in live],
               "retired": s.tree_np(retired.compute()), "merged": None}
        if case.name not in _NO_MERGE:
            m_a, m_b = engine.expire(sids[0]), engine.expire(sids[2])
            m_a.merge_state(m_b)
            out["merged"] = s.tree_np(m_a.compute())
    return out


def _port_lifecycle(case, batches):
    """The lifecycle through the port's engine, each step held against per-instance oracles."""
    from metrics_tpu_torch import observe
    from metrics_tpu_torch.engine.stream import StreamEngine

    ctor = PORT_CTORS[case.name]
    feed_batches = iter(batches)
    with observe.scope(reset=True):
        engine = StreamEngine(initial_capacity=4)
        sids = [engine.add_session(ctor()) for _ in range(3)]
        oracles = {sid: ctor() for sid in sids}

        def feed(active):
            for sid in active:
                args = [to_torch(a) for a in next(feed_batches)]
                engine.submit(sid, *args)
                oracles[sid].update(*args)
            assert engine.tick() == 1

        feed(sids)
        feed(sids)
        bucket = engine._sessions[sids[0]].bucket
        assert bucket is not None, f"{case.name} did not form a bucket"
        idle = sids[1]
        before_idle = _row(engine, idle)
        free_slot = bucket.free[-1]
        before_virgin = {k: _np(v[free_slot]) for k, v in bucket.stacked.items()}
        feed([sids[0], sids[2]])  # masked flush: the idle row and the virgin row pass through untouched
        _equal_rows(_row(engine, idle), before_idle, "masked row")
        _equal_rows({k: _np(v[free_slot]) for k, v in bucket.stacked.items()}, before_virgin, "virgin row")
        retired = engine.expire(idle)  # churn: the retiree computes on its own row, like its oracle
        _close(retired.compute(), oracles[idle].compute(), "expired session")
        replacement = engine.add_session(ctor())
        oracles[replacement] = ctor()
        live = [sids[0], sids[2], replacement]
        feed(live)  # the recycled slot rides the masked dispatch
        for sid in live:
            assert engine.session_health(sid) == "healthy"
            _equal_rows(_row(engine, sid), {k: _np(v) for k, v in oracles[sid]._state.items()}, f"session {sid}")
            _close(engine.compute(sid), oracles[sid].compute(), f"compute {sid}")
        assert observe.snapshot()["counters"].get("fleet_loose_update") is None
        with tempfile.TemporaryDirectory() as tmp:  # a checkpoint round trip lands every row bit-exactly
            ckpt = engine.checkpoint(os.path.join(tmp, "fleet.ckpt"))
            restored = StreamEngine.restore(ckpt)
            for sid in live:
                _equal_rows(_row(restored, sid), _row(engine, sid), f"restored {sid}")
        out = {"rows": [_row(engine, sid) for sid in live],
               "values": [_np_tree(engine.compute(sid)) for sid in live],
               "retired": _np_tree(retired.compute()), "merged": None}
        m_a, m_b = engine.expire(sids[0]), engine.expire(sids[2])
        o_a, o_b = oracles[sids[0]], oracles[sids[2]]
        if case.name in _NO_MERGE:
            with pytest.raises(RuntimeError, match="merge_state"):
                o_a.merge_state(o_b)
            with pytest.raises(RuntimeError, match="merge_state"):
                m_a.merge_state(m_b)
        else:
            o_a.merge_state(o_b)
            m_a.merge_state(m_b)
            _close(m_a.compute(), o_a.compute(), "merged")
            out["merged"] = _np_tree(m_a.compute())
    return out


def _np_tree(value):
    if isinstance(value, dict):
        return {k: _np_tree(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_np_tree(v) for v in value)
    return _np(value)


@pytest.mark.parametrize("case", _CASES, ids=lambda c: c.name)
def test_class_rides_a_churning_bucket_bit_exact(case):
    from metrics_tpu_torch.engine.core import _FLEET_JIT_CACHE

    batches = _batches(case)
    _FLEET_JIT_CACHE.clear()
    try:
        port = _port_lifecycle(case, batches)
    finally:
        _FLEET_JIT_CACHE.clear()
    ref = _jax_lifecycle(case, batches)
    tol = _CROSS_TOL.get(case.name, (_RTOL, _ATOL))
    for i, (got, want) in enumerate(zip(port["rows"], ref["rows"])):
        assert set(got) == set(want), f"live session {i}: state names"
        for k, w in want.items():
            g = got[k]
            if w.dtype.kind == "f" or g.dtype.kind == "f":
                _close(g, w, f"live session {i}: state {k!r} against the JAX engine's", *tol)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"live session {i}: state {k!r} against the JAX engine's")
    _close(port["values"], ref["values"], "computes against the JAX engine's", *tol)
    _close(port["retired"], ref["retired"], "the retiree's compute against the JAX engine's", *tol)
    assert (port["merged"] is None) == (ref["merged"] is None)
    if ref["merged"] is not None:
        _close(port["merged"], ref["merged"], "the merged compute against the JAX engine's", *tol)
