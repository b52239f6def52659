"""The port's durability layer against the JAX package's: input guards, ``state_avals`` and
``config_fingerprint``, checkpoints (the container format shared, the identities not), and MAP's list states
through a fake two-rank sync.

Guards: states bit-equal after a poisoned batch under ``skip_batch`` and ``raise_on_host`` for each state
kind the guard accepts (int counters, float sums, a 2-D confusion matrix, mean, max and moment states), the
counter, the errors and the fixed-shape check's message, each beside the JAX package's on the same inputs.
Checkpoints: round trips bit-exact; corrupt, truncated and mismatched files refused before anything is
installed; either package's ``_parse`` reads the other's files into equal node trees; a JAX-written file is
refused by the port and a port-written one by the JAX package; MAP's and the exact-mode curves' restores
refused in both packages. Then the framework-neutral cases of the JAX package's
``tests/test_resilience_checkpoint.py`` and ``test_resilience_guards.py`` on the port.

Tolerances: states are compared bit for bit (integers equal, floats by their bits); computed values of the
two packages within ``rtol=1e-6`` (float32 scores from equal counters).
"""

from __future__ import annotations

import copy
import os
import pickle
import re
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.aggregation as ja
import metrics_tpu.classification as jc
import metrics_tpu.detection as jd
import metrics_tpu.regression as jr
import metrics_tpu.resilience as jres
import metrics_tpu_torch.aggregation as ta
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.detection as td
import metrics_tpu_torch.observe as tobs
import metrics_tpu_torch.regression as tr
import metrics_tpu_torch.resilience as tres
from metrics_tpu.collections import MetricCollection as JCollection
from metrics_tpu.resilience import checkpoint as jckpt
from metrics_tpu_torch.collections import MetricCollection as TCollection
from metrics_tpu_torch.resilience import checkpoint as tckpt
from metrics_tpu_torch.utils.exceptions import TPUMetricsUserError

VALUE_RTOL = 1e-6


def _np(x):
    if isinstance(x, list):
        return [_np(v) for v in x]
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a):
    a = np.ascontiguousarray(_np(a))
    return a.view(np.dtype(f"u{a.itemsize}")) if a.dtype.kind == "f" else a


def _same_bits(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)


def _state(m):
    return {k: (list(v) if isinstance(v, list) else v.clone()) for k, v in m.metric_state.items()}


def _binary(seed=0, n=32, nan=False):
    rng = np.random.RandomState(seed)
    preds, target = rng.rand(n).astype(np.float32), rng.randint(0, 2, n)
    if nan:
        preds[0] = np.nan
    return preds, target


def _multiclass(seed=0, n=32, nan=False):
    rng = np.random.RandomState(seed)
    preds, target = rng.rand(n, 4).astype(np.float32), rng.randint(0, 4, n)
    if nan:
        preds[3, 1] = np.inf
    return preds, target


def _regress(seed=0, n=32, nan=False):
    rng = np.random.RandomState(seed)
    x, y = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    if nan:
        y[5] = np.nan
    return x, y


def _values(seed=0, n=32, nan=False):
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    if nan:
        x[2] = -np.inf
    return (x,)


# (name, port factory, JAX factory, inputs(seed, nan)) — one per state kind the guard accepts
GUARDABLE = [
    ("BinaryAccuracy[int counters]", lambda: tc.BinaryAccuracy(device="cpu"), jc.BinaryAccuracy, _binary),
    ("MulticlassConfusionMatrix[2-D int]", lambda: tc.MulticlassConfusionMatrix(num_classes=4, device="cpu"),
     lambda: jc.MulticlassConfusionMatrix(num_classes=4), _multiclass),
    ("MeanSquaredError[float sum, count]", lambda: tr.MeanSquaredError(device="cpu"), jr.MeanSquaredError,
     _regress),
    ("PearsonCorrCoef[float moments]", lambda: tr.PearsonCorrCoef(device="cpu"), jr.PearsonCorrCoef, _regress),
    ("MeanMetric[mean]", lambda: ta.MeanMetric(nan_strategy="ignore", device="cpu"),
     lambda: ja.MeanMetric(nan_strategy="ignore"), _values),
    ("MaxMetric[max]", lambda: ta.MaxMetric(nan_strategy="ignore", device="cpu"),
     lambda: ja.MaxMetric(nan_strategy="ignore"), _values),
]
GUARD_IDS = [g[0] for g in GUARDABLE]


def _feed(m, inputs, torch_side):
    m.update(*[torch.from_numpy(np.asarray(x)) if torch_side else jnp.asarray(x) for x in inputs])


# ----------------------------------------------------------------------------- guards
@pytest.mark.parametrize("policy", ["skip_batch", "raise_on_host"])
@pytest.mark.parametrize(("name", "port_make", "ref_make", "inputs"), GUARDABLE, ids=GUARD_IDS)
def test_a_poisoned_batch_leaves_every_state_bit_equal(name, port_make, ref_make, inputs, policy):
    port, ref = tres.install_guard(port_make(), policy), jres.install_guard(ref_make(), policy)
    for seed in (0, 1):
        _feed(port, inputs(seed), True)
        _feed(ref, inputs(seed), False)
    before = {k: v for k, v in _state(port).items() if k != tres.GUARD_STATE}
    for metric, torch_side in ((port, True), (ref, False)):
        if policy == "raise_on_host":
            with pytest.raises((tres.PoisonedInputError, jres.PoisonedInputError), match="quarantined"):
                _feed(metric, inputs(2, nan=True), torch_side)
        else:
            _feed(metric, inputs(2, nan=True), torch_side)
    after = {k: v for k, v in port.metric_state.items() if k != tres.GUARD_STATE}
    _same_bits(before, after)
    assert tres.poisoned_count(port) == jres.poisoned_count(ref) == 1
    assert port.metric_state[tres.GUARD_STATE].dtype == torch.int64  # the JAX package's is int32 under x32
    for metric, torch_side in ((port, True), (ref, False)):
        _feed(metric, inputs(3), torch_side)
    for key, value in ref.metric_state.items():
        got = _np(port.metric_state[key])
        np.testing.assert_allclose(got.astype(np.float64), np.asarray(value, np.float64), rtol=VALUE_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(np.asarray(_np(port.compute()), np.float64),
                               np.asarray(ref.compute(), np.float64), rtol=VALUE_RTOL)


def test_skip_batch_equals_the_stream_without_the_poisoned_batch():
    guarded = tres.install_guard(tc.BinaryAccuracy(device="cpu"), policy="skip_batch")
    control = tc.BinaryAccuracy(device="cpu")
    for seed, nan in ((0, False), (2, True), (1, False)):
        _feed(guarded, _binary(seed, nan=nan), True)
        if not nan:
            _feed(control, _binary(seed), True)
    assert tres.poisoned_count(guarded) == 1
    _same_bits({k: v for k, v in guarded.metric_state.items() if k != tres.GUARD_STATE}, control.metric_state)
    assert torch.equal(guarded.compute(), control.compute())


def test_propagate_counts_and_lets_the_values_flow_as_the_jax_package():
    port = tres.install_guard(tr.MeanSquaredError(device="cpu"), policy="propagate")
    ref = jres.install_guard(jr.MeanSquaredError(), policy="propagate")
    _feed(port, _regress(0, nan=True), True)
    _feed(ref, _regress(0, nan=True), False)
    assert tres.poisoned_count(port) == jres.poisoned_count(ref) == 1
    assert np.isnan(float(port.compute())) and np.isnan(float(ref.compute()))


def test_raise_on_host_raises_then_continues_and_records_the_quarantine():
    with tobs.scope():
        guarded = tres.install_guard(tc.BinaryAccuracy(device="cpu"), policy="raise_on_host")
        _feed(guarded, _binary(0), True)
        with pytest.raises(tres.PoisonedInputError, match=r"quarantined \(1 poisoned batch\(es\) total\)"):
            _feed(guarded, _binary(1, nan=True), True)
        _feed(guarded, _binary(2), True)
        snap = tobs.snapshot()
    control = tc.BinaryAccuracy(device="cpu")
    _feed(control, _binary(0), True)
    _feed(control, _binary(2), True)
    assert tres.poisoned_count(guarded) == 1 and torch.equal(guarded.compute(), control.compute())
    assert snap["counters"]["guard_quarantined"] == {"BinaryAccuracy": 1}
    assert snap["derived"]["guard_quarantined_total"] == 1
    # the update itself completed: it is counted and not rolled back
    assert snap["counters"]["update_eager"] == {"BinaryAccuracy": 3} and "update_rolled_back" not in snap["counters"]


def test_guard_errors_and_the_fixed_shape_check_match_the_jax_package():
    with pytest.raises(TPUMetricsUserError) as port_err:
        tres.install_guard(tc.BinaryAccuracy(device="cpu"), policy="nope")
    with pytest.raises(Exception) as ref_err:
        jres.install_guard(jc.BinaryAccuracy(), policy="nope")
    assert str(port_err.value) == str(ref_err.value)
    for port_make, ref_make in ((lambda: ta.CatMetric(device="cpu"), ja.CatMetric),
                                (lambda: tc.BinaryAUROC(device="cpu"), jc.BinaryAUROC)):
        with pytest.raises(TPUMetricsUserError) as port_err:
            tres.install_guard(port_make(), policy="skip_batch")
        with pytest.raises(Exception) as ref_err:
            jres.install_guard(ref_make(), policy="skip_batch")
        assert str(port_err.value) == str(ref_err.value)
        assert "Use policy='propagate'" in str(port_err.value)
        tres.install_guard(port_make(), policy="propagate")
    assert tres.GUARD_POLICIES == jres.GUARD_POLICIES and tres.GUARD_STATE == jres.GUARD_STATE
    assert issubclass(tres.PoisonedInputError, TPUMetricsUserError)


def test_a_python_inf_argument_is_a_static_flag():
    port = tres.install_guard(ta.MeanMetric(device="cpu"), policy="skip_batch")
    ref = jres.install_guard(ja.MeanMetric(), policy="skip_batch")
    port.update(torch.tensor([1.0, 2.0]))
    ref.update(jnp.asarray([1.0, 2.0]))
    port.update(torch.tensor([3.0]), float("inf"))
    ref.update(jnp.asarray([3.0]), float("inf"))
    assert tres.poisoned_count(port) == jres.poisoned_count(ref) == 1
    assert float(port.compute()) == float(ref.compute()) == 1.5


def test_the_guard_runs_in_the_functional_update_too():
    guarded = tres.install_guard(tc.BinaryAccuracy(device="cpu"), policy="skip_batch")
    fns = guarded.functional()
    state = fns.update(fns.init(), *[torch.from_numpy(x) for x in _binary(0)])
    poisoned = fns.update(state, *[torch.from_numpy(x) for x in _binary(1, nan=True)])
    assert int(poisoned[tres.GUARD_STATE]) == 1
    _same_bits({k: v for k, v in poisoned.items() if k != tres.GUARD_STATE},
               {k: v for k, v in state.items() if k != tres.GUARD_STATE})
    assert guarded.update_count == 0 and int(guarded.metric_state[tres.GUARD_STATE]) == 0


def test_guard_counter_is_an_ordinary_state():
    a = tres.install_guard(tc.BinaryAccuracy(device="cpu"), policy="skip_batch")
    b = tres.install_guard(tc.BinaryAccuracy(device="cpu"), policy="skip_batch")
    _feed(a, _binary(0, nan=True), True)
    _feed(b, _binary(1, nan=True), True)
    a.merge_state(b)
    assert tres.poisoned_count(a) == 2
    a.sync(dist_sync_fn=lambda states, group: [[s, s] for s in states], distributed_available=True)
    assert tres.poisoned_count(a) == 4
    a.unsync()
    assert a.state_dict()[tres.GUARD_STATE] == 2  # persistent, as in the JAX package
    a.reset()
    assert tres.poisoned_count(a) == 0
    clone = pickle.loads(pickle.dumps(b))
    assert clone._guard_policy == "skip_batch" and tres.poisoned_count(clone) == 1


# ----------------------------------------------------------------------------- state_avals, config_fingerprint
AVAL_CASES = [
    ("BinaryAccuracy", lambda: tc.BinaryAccuracy(device="cpu"), jc.BinaryAccuracy),
    ("MulticlassConfusionMatrix", lambda: tc.MulticlassConfusionMatrix(num_classes=4, device="cpu"),
     lambda: jc.MulticlassConfusionMatrix(num_classes=4)),
    ("MeanSquaredError", lambda: tr.MeanSquaredError(device="cpu"), jr.MeanSquaredError),
    ("PearsonCorrCoef", lambda: tr.PearsonCorrCoef(device="cpu"), jr.PearsonCorrCoef),
    ("MeanMetric", lambda: ta.MeanMetric(device="cpu"), ja.MeanMetric),
    ("CatMetric", lambda: ta.CatMetric(device="cpu"), ja.CatMetric),
    ("MultilabelAveragePrecision", lambda: tc.MultilabelAveragePrecision(num_labels=3, thresholds=5, device="cpu"),
     lambda: jc.MultilabelAveragePrecision(num_labels=3, thresholds=5)),
    ("MulticlassAUROC[exact]", lambda: tc.MulticlassAUROC(num_classes=3, device="cpu"),
     lambda: jc.MulticlassAUROC(num_classes=3)),
    ("MeanAveragePrecision", lambda: td.MeanAveragePrecision(device="cpu"), jd.MeanAveragePrecision),
]
AVAL_IDS = [c[0] for c in AVAL_CASES]


@pytest.mark.parametrize(("name", "port_make", "ref_make"), AVAL_CASES, ids=AVAL_IDS)
def test_state_avals_equal_the_jax_package_but_for_the_int64_counters(name, port_make, ref_make):
    port, ref = port_make().state_avals(), ref_make().state_avals()
    assert [(n, s) for n, s, _ in port] == [(n, s) for n, s, _ in ref]
    for (n, _, pd), (_, _, rd) in zip(port, ref):
        assert pd == rd or (pd, rd) == ("int64", "int32"), n


@pytest.mark.parametrize(("name", "port_make", "ref_make"), AVAL_CASES, ids=AVAL_IDS)
def test_config_fingerprint_is_stable_across_clone_and_pickle_and_changed_by_a_guard(name, port_make, ref_make):
    m = port_make()
    fp = m.config_fingerprint()
    assert fp is not None and len(fp) == 64
    assert port_make().config_fingerprint() == fp
    assert m.clone().config_fingerprint() == fp and copy.deepcopy(m).config_fingerprint() == fp
    assert pickle.loads(pickle.dumps(m)).config_fingerprint() == fp
    assert fp != ref_make().config_fingerprint()  # the port spells its own module path
    m.__dict__["device"] = torch.device("cuda")  # the device is not configuration
    assert m.config_fingerprint() == fp
    m.__dict__["device"] = torch.device("cpu")
    if name not in ("CatMetric", "MulticlassAUROC[exact]", "MeanAveragePrecision"):
        assert tres.install_guard(m, "skip_batch").config_fingerprint() != fp
    else:
        assert tres.install_guard(m, "propagate").config_fingerprint() != fp


def test_config_fingerprint_follows_the_arguments_and_is_none_for_child_metrics():
    a = tc.MulticlassAccuracy(num_classes=4, device="cpu")
    assert a.config_fingerprint() != tc.MulticlassAccuracy(num_classes=5, device="cpu").config_fingerprint()
    assert a.config_fingerprint() != tc.MulticlassAccuracy(num_classes=4, average="micro",
                                                           device="cpu").config_fingerprint()
    grid = torch.tensor([0.0, 0.25, 0.5, 1.0])
    thresholds = tc.BinaryAUROC(thresholds=grid, device="cpu")
    assert thresholds.config_fingerprint() == tc.BinaryAUROC(thresholds=grid.clone(), device="cpu").config_fingerprint()
    assert thresholds.config_fingerprint() != tc.BinaryAUROC(thresholds=grid + 0.125, device="cpu").config_fingerprint()
    assert (tc.BinaryAccuracy(device="cpu") + tc.BinaryAccuracy(device="cpu")).config_fingerprint() is None


# ----------------------------------------------------------------------------- checkpoints: round trips
def _fed_port(make, feed, seeds):
    m = make()
    for s in seeds:
        feed(m, s)
    return m


def _acc_feed(m, s):
    _feed(m, _binary(s), True)


def _cat_feed(m, s):
    m.update(torch.from_numpy(np.random.RandomState(s).rand(3 + s).astype(np.float32)))


@pytest.mark.parametrize(("make", "feed"), [
    (lambda: tc.BinaryAccuracy(device="cpu"), _acc_feed),
    (lambda: tc.MulticlassConfusionMatrix(num_classes=4, device="cpu"),
     lambda m, s: _feed(m, _multiclass(s), True)),
    (lambda: tr.PearsonCorrCoef(device="cpu"), lambda m, s: _feed(m, _regress(s), True)),
    (lambda: ta.CatMetric(device="cpu"), _cat_feed),
    (lambda: tc.MultilabelAveragePrecision(num_labels=3, thresholds=5, device="cpu"),
     lambda m, s: m.update(torch.from_numpy(np.random.RandomState(s).rand(8, 3).astype(np.float32)),
                           torch.from_numpy(np.random.RandomState(s + 9).randint(0, 2, (8, 3))))),
], ids=["BinaryAccuracy", "MulticlassConfusionMatrix", "PearsonCorrCoef", "CatMetric[list]",
        "MultilabelAveragePrecision"])
def test_metric_roundtrip_is_bit_exact(tmp_path, make, feed):
    m = _fed_port(make, feed, (0, 1))
    path = str(tmp_path / "m.ckpt")
    assert tres.save_checkpoint(m, path) == path
    fresh = tres.restore_checkpoint(make(), path)
    assert fresh.state_fingerprint() == m.state_fingerprint()
    assert fresh.update_count == m.update_count == 2
    np.testing.assert_array_equal(np.asarray(_np(fresh.compute()), np.float64), np.asarray(_np(m.compute()), np.float64))
    feed(fresh, 2)
    feed(m, 2)
    assert fresh.state_fingerprint() == m.state_fingerprint()


def test_collection_roundtrip_keeps_its_compute_groups(tmp_path):
    def make():
        return TCollection([tc.MulticlassPrecision(num_classes=4, device="cpu"),
                            tc.MulticlassRecall(num_classes=4, device="cpu"),
                            tc.MulticlassConfusionMatrix(num_classes=4, device="cpu")])

    col = make()
    for s in (0, 1):
        col.update(*[torch.from_numpy(x) for x in _multiclass(s)])
    path = str(tmp_path / "col.ckpt")
    tres.save_checkpoint(col, path)
    fresh = tres.restore_checkpoint(make(), path)
    for s in (2, 3):
        for c in (col, fresh):
            c.update(*[torch.from_numpy(x) for x in _multiclass(s)])
    assert fresh.compute_groups == col.compute_groups == {0: ["MulticlassPrecision", "MulticlassRecall"],
                                                          1: ["MulticlassConfusionMatrix"]}
    for name in col.keys():
        assert fresh[name].state_fingerprint() == col[name].state_fingerprint()


def test_restore_records_telemetry_and_spans(tmp_path):
    m = _fed_port(lambda: tc.BinaryAccuracy(device="cpu"), _acc_feed, (0,))
    path = str(tmp_path / "a.ckpt")
    with tobs.scope():
        tres.save_checkpoint(m, path)
        tres.restore_checkpoint(tc.BinaryAccuracy(device="cpu"), path)
        snap = tobs.snapshot()
    assert snap["derived"]["ckpt_saves_total"] == snap["derived"]["ckpt_restores_total"] == 1
    [save] = [e for e in snap["events"] if e["kind"] == "ckpt_save"]
    assert save["bytes"] == os.path.getsize(path) and save["target"] == "BinaryAccuracy"
    assert set(snap["latency"]["ckpt"]) == {"save", "restore"}


# ----------------------------------------------------------------------------- checkpoints: refusals
def _saved(tmp_path, name="a.ckpt"):
    m = _fed_port(lambda: tc.BinaryAccuracy(device="cpu"), _acc_feed, (0,))
    path = str(tmp_path / name)
    tres.save_checkpoint(m, path)
    return path, open(path, "rb").read()


def _write(tmp_path, blob, name="broken.ckpt"):
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(blob)
    return path


def _header_len(blob):
    return int.from_bytes(blob[8:12], "big")


@pytest.mark.parametrize("damage", ["truncated", "bitflip", "trailing", "magic", "header_crc", "version",
                                    "empty"])
def test_damaged_checkpoints_are_refused_and_leave_the_target_untouched(tmp_path, damage):
    _, blob = _saved(tmp_path)
    if damage == "truncated":
        bad = blob[:-7]
    elif damage == "bitflip":
        bad = bytearray(blob)
        bad[-1] ^= 0xFF
    elif damage == "trailing":
        bad = blob + b"garbage"
    elif damage == "magic":
        bad = b"MTCKPT02" + blob[8:]
    elif damage == "header_crc":
        bad = bytearray(blob)
        bad[16 + 3] ^= 0x01
    elif damage == "version":
        import json

        header = json.loads(blob[16:16 + _header_len(blob)])
        header["format_version"] = 2
        body = json.dumps(header, sort_keys=True).encode()
        bad = blob[:8] + len(body).to_bytes(4, "big") + (zlib.crc32(body) & 0xFFFFFFFF).to_bytes(4, "big") + body \
            + blob[16 + _header_len(blob):]
    else:
        bad = b""
    target = _fed_port(lambda: tc.BinaryAccuracy(device="cpu"), _acc_feed, (5,))
    before = target.state_fingerprint()
    with pytest.raises(tres.CorruptCheckpointError):
        tres.restore_checkpoint(target, _write(tmp_path, bytes(bad)))
    assert target.state_fingerprint() == before
    with pytest.raises(jres.CorruptCheckpointError):  # the JAX package refuses the same bytes
        jres.restore_checkpoint(jc.BinaryAccuracy(), _write(tmp_path, bytes(bad), "jax.ckpt"))


def test_a_missing_file_is_a_checkpoint_error(tmp_path):
    with pytest.raises(tres.CheckpointError, match="cannot read checkpoint"):
        tres.restore_checkpoint(tc.BinaryAccuracy(device="cpu"), str(tmp_path / "nope.ckpt"))


def test_wrong_class_config_members_or_regime_are_incompatible(tmp_path):
    path, _ = _saved(tmp_path)
    with pytest.raises(tres.IncompatibleCheckpointError, match="saved from BinaryAccuracy"):
        tres.restore_checkpoint(ta.MeanMetric(device="cpu"), path)
    with pytest.raises(tres.IncompatibleCheckpointError, match="fingerprint"):
        tres.restore_checkpoint(tc.BinaryAccuracy(threshold=0.7, device="cpu"), path)
    with pytest.raises(tres.IncompatibleCheckpointError, match="expected a metric node|MetricCollection"):
        tres.restore_checkpoint(TCollection([tc.BinaryAccuracy(device="cpu")]), path)
    col = TCollection([tc.BinaryAccuracy(device="cpu"), tc.BinaryF1Score(device="cpu")])
    col.update(*[torch.from_numpy(x) for x in _binary(0)])
    tres.save_checkpoint(col, path)
    with pytest.raises(tres.IncompatibleCheckpointError, match="unexpected: \\['BinaryF1Score'\\]"):
        tres.restore_checkpoint(TCollection([tc.BinaryAccuracy(device="cpu")]), path)
    target = ta.SumMetric(device="cpu")
    target.update(torch.tensor(1.0))
    tres.save_checkpoint(target, path)
    node = tckpt._parse(open(path, "rb").read(), path)
    assert node["avals"]["sum_value"]["dtype"] == "float32"
    assert tckpt._dtype_matches("float32", "float32") and not tckpt._dtype_matches("float64", "float32")
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        assert tckpt._dtype_matches("float64", "float32") and tckpt._dtype_matches("int64", "int32")
        with pytest.raises(tres.IncompatibleCheckpointError, match="precision regime mismatch"):
            tres.restore_checkpoint(ta.SumMetric(device="cpu"), path)  # float64 state, float32 payload
    finally:
        torch.set_default_dtype(previous)


def test_save_is_atomic_and_leaves_no_partial_files(tmp_path):
    m = _fed_port(lambda: tc.BinaryAccuracy(device="cpu"), _acc_feed, (0,))
    path = str(tmp_path / "acc.ckpt")
    tres.save_checkpoint(m, path)
    tres.save_checkpoint(m, path)
    assert os.listdir(tmp_path) == ["acc.ckpt"]

    class Boom(Exception):
        pass

    def chunks():
        yield b"partial"
        raise Boom

    from metrics_tpu_torch.utils import io as tio

    with pytest.raises(Boom):
        tio.atomic_write_chunks(str(tmp_path / "acc.ckpt"), chunks())
    assert os.listdir(tmp_path) == ["acc.ckpt"] and tckpt._parse(open(path, "rb").read(), path)["kind"] == "metric"
    tio.atomic_write_text(str(tmp_path / "t.txt"), "héllo")
    assert open(tmp_path / "t.txt", encoding="utf-8").read() == "héllo"


def test_chunked_crc_manifests_and_file_crc_equal_the_jax_package(tmp_path):
    rng = np.random.RandomState(42)
    parts = [rng.bytes(n) for n in (0, 1, 7, 1 << 10, (1 << 16) + 13)]
    joined = b"".join(parts)
    for chunk in (1, 3, 1 << 8, 1 << 22):
        assert tckpt._crc32_chunked(*parts, chunk_size=chunk) == zlib.crc32(joined) & 0xFFFFFFFF
    assert tckpt._crc32_chunked() == 0
    node = {"shards": ["a.ckpt", "b.ckpt"], "n": 2}
    tckpt.save_manifest(tmp_path / "m.man", node)
    jckpt.save_manifest(tmp_path / "j.man", node)
    assert open(tmp_path / "m.man", "rb").read() == open(tmp_path / "j.man", "rb").read()
    assert tckpt.load_manifest(tmp_path / "j.man") == node == jckpt.load_manifest(tmp_path / "m.man")
    assert tckpt.file_crc32(tmp_path / "m.man", chunk_size=5) == jckpt.file_crc32(tmp_path / "m.man")
    blob = open(tmp_path / "m.man", "rb").read()
    for bad in (blob[:-1], blob + b"x", b"XXXXXXXX" + blob[8:]):
        with open(tmp_path / "bad.man", "wb") as fh:
            fh.write(bad)
        with pytest.raises(tres.CorruptCheckpointError):
            tckpt.load_manifest(tmp_path / "bad.man")


def test_periodic_checkpointer_fires_on_cadence(tmp_path):
    m = tc.BinaryAccuracy(device="cpu")
    path = str(tmp_path / "periodic.ckpt")
    ck = tres.PeriodicCheckpointer(m, path, tres.SnapshotPolicy(every_n_updates=3))
    fired = []
    for i in range(7):
        _acc_feed(m, i)
        fired.append(ck.step())
    assert fired == [False, False, True, False, False, True, False] and ck.saves == 2
    assert tres.restore_checkpoint(tc.BinaryAccuracy(device="cpu"), path).update_count == 6
    timed = tres.PeriodicCheckpointer(m, str(tmp_path / "timed.ckpt"), tres.SnapshotPolicy(every_n_updates=None,
                                                                                          every_s=0.0))
    assert timed.step() and timed.saves == 1
    manual = tres.PeriodicCheckpointer(m, str(tmp_path / "manual.ckpt"), tres.SnapshotPolicy(None, None))
    assert not any(manual.step() for _ in range(5)) and manual.save() == str(tmp_path / "manual.ckpt")


def test_a_wrapper_of_replicas_is_refused_until_the_engine_port(tmp_path):
    # the engine's port has landed: a wrapper of replicas now saves as the JAX package's "replicated" node
    # (its stacked rows materialized first) and restores every replica's state and count
    from metrics_tpu_torch.wrappers import BootStrapper

    np.random.seed(7)
    w = BootStrapper(tc.BinaryAccuracy(device="cpu"), num_bootstraps=3)
    w.update(torch.tensor([0.2, 0.8, 0.6, 0.1]), torch.tensor([0, 1, 0, 1]))
    assert w.__dict__["_stacked"] is not None  # the replica engine holds the rows
    path = tres.save_checkpoint(w, str(tmp_path / "boot.ckpt"))
    from metrics_tpu_torch.resilience.checkpoint import _parse

    node = _parse(open(path, "rb").read(), path)
    assert node["kind"] == "replicated" and len(node["replicas"]) == 3
    fresh = BootStrapper(tc.BinaryAccuracy(device="cpu"), num_bootstraps=3)
    tres.restore_checkpoint(fresh, path)
    for a, b in zip(w.metrics, fresh.metrics):
        assert a.update_count == b.update_count == 1
        assert all(torch.equal(a.metric_state[k], b.metric_state[k]) for k in a._defaults)
    with pytest.raises(tres.IncompatibleCheckpointError, match="replicas"):
        tres.restore_checkpoint(BootStrapper(tc.BinaryAccuracy(device="cpu"), num_bootstraps=4), path)


# ----------------------------------------------------------------------------- across the two packages
def _plain_tree(node):
    """Every leaf of a port-written node tree is a builtin or a numpy array (no torch object was pickled)."""
    if isinstance(node, dict):
        return all(isinstance(k, str) and _plain_tree(v) for k, v in node.items())
    if isinstance(node, list):
        return all(_plain_tree(v) for v in node)
    return node is None or isinstance(node, (str, int, float, bool, np.ndarray))


def _trees_equal(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    return a == b


def test_either_package_parses_the_others_files_into_equal_node_trees(tmp_path):
    port = TCollection([tc.BinaryAccuracy(device="cpu"), tc.BinaryF1Score(device="cpu")])
    ref = JCollection([jc.BinaryAccuracy(), jc.BinaryF1Score()])
    preds, target = _binary(0)
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    cat_p, cat_j = ta.CatMetric(device="cpu"), ja.CatMetric()
    for part in (preds[:5], preds[5:]):
        cat_p.update(torch.from_numpy(part))
        cat_j.update(jnp.asarray(part))
    nodes = {}
    for name, obj, save in (("port", port, tres.save_checkpoint), ("jax", ref, jres.save_checkpoint),
                            ("port_cat", cat_p, tres.save_checkpoint), ("jax_cat", cat_j, jres.save_checkpoint)):
        path = str(tmp_path / f"{name}.ckpt")
        save(obj, path)
        blob = open(path, "rb").read()
        nodes[name] = tckpt._parse(blob, path)
        assert _trees_equal(nodes[name], jckpt._parse(blob, path)), name
    from_port, jax_node = nodes["port"], nodes["jax"]
    assert _plain_tree(from_port) and _plain_tree(nodes["port_cat"])
    assert [a.shape for a in nodes["port_cat"]["state"]["value"]] == [(5,), (27,)]
    assert _trees_equal(nodes["port_cat"]["state"], nodes["jax_cat"]["state"])
    for name in ("BinaryAccuracy", "BinaryF1Score"):
        mine, theirs = from_port["members"][name], jax_node["members"][name]
        assert (mine["kind"], mine["class"], mine["update_count"]) == (theirs["kind"], theirs["class"],
                                                                      theirs["update_count"])
        assert mine["state"].keys() == theirs["state"].keys()
        for key, value in theirs["state"].items():
            np.testing.assert_array_equal(np.asarray(mine["state"][key]), np.asarray(value))
    assert from_port["members"]["BinaryAccuracy"]["avals"]["tp"] == {"shape": [1], "dtype": "int64"}
    assert jax_node["members"]["BinaryAccuracy"]["avals"]["tp"] == {"shape": [1], "dtype": "int32"}


def test_a_checkpoint_of_the_other_package_is_refused_in_both_directions(tmp_path):
    preds, target = _binary(0)
    port, ref = tc.BinaryAccuracy(device="cpu"), jc.BinaryAccuracy()
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    p_path, j_path = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    tres.save_checkpoint(port, p_path)
    jres.save_checkpoint(ref, j_path)
    target_metric = tc.BinaryAccuracy(device="cpu")
    with pytest.raises(tres.IncompatibleCheckpointError, match="fingerprint"):
        tres.restore_checkpoint(target_metric, j_path)
    assert target_metric.update_count == 0
    with pytest.raises(jres.IncompatibleCheckpointError, match="fingerprint"):
        jres.restore_checkpoint(jc.BinaryAccuracy(), p_path)
    # without the fingerprints, the exact-dtype check refuses the int32 counters as well
    node = jckpt._parse(open(j_path, "rb").read(), j_path)
    node["fingerprint"] = None
    with pytest.raises(tres.IncompatibleCheckpointError, match="checkpointed as dtype int32 but this process "
                                                               "expects int64"):
        tckpt._validate(tc.BinaryAccuracy(device="cpu"), node, "BinaryAccuracy")
    # state crosses packages through load_reference_state
    from metrics_tpu_torch.interop import load_reference_state

    ref.persistent(True)
    carried = load_reference_state(tc.BinaryAccuracy(device="cpu"), ref.state_dict())
    assert float(carried.compute()) == pytest.approx(float(ref.compute()), rel=VALUE_RTOL)


def _map_pair(n_images=6):
    sys.path.insert(0, os.path.dirname(__file__))
    try:
        from test_torch_detection import _images, _torch
    finally:
        sys.path.pop(0)
    images = _images(3, n=n_images)
    return images, _torch


@pytest.mark.parametrize("case", ["MeanAveragePrecision", "MulticlassAUROC[exact]"])
def test_map_and_exact_curve_restores_are_refused_in_both_packages(tmp_path, case):
    """A reference caveat the port keeps: a list state's elements are held to the metric's float dtype, so
    MAP's integer labels (and an exact curve's integer targets) cannot be restored, in either package."""
    if case == "MeanAveragePrecision":
        images, to_torch = _map_pair()
        port, ref = td.MeanAveragePrecision(device="cpu"), jd.MeanAveragePrecision()
        port.update([to_torch(p) for p, _ in images], [to_torch(t) for _, t in images])
        ref.update([p for p, _ in images], [t for _, t in images])
        make_port, make_ref, refused = (lambda: td.MeanAveragePrecision(device="cpu"), jd.MeanAveragePrecision,
                                        "state 'detection_label' expects dtype float32 (shape ()) but got int")
    else:
        preds, target = _multiclass(0)
        preds = preds[:, :3]
        target = target % 3
        port, ref = tc.MulticlassAUROC(num_classes=3, device="cpu"), jc.MulticlassAUROC(num_classes=3)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        make_port, make_ref, refused = (lambda: tc.MulticlassAUROC(num_classes=3, device="cpu"),
                                        lambda: jc.MulticlassAUROC(num_classes=3),
                                        "state 'target' expects dtype float32 (shape ()) but got int")
    p_path, j_path = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    tres.save_checkpoint(port, p_path)
    jres.save_checkpoint(ref, j_path)
    target = make_port()
    with pytest.raises(tres.IncompatibleCheckpointError, match=re.escape(refused)):
        tres.restore_checkpoint(target, p_path)
    assert target.update_count == 0
    with pytest.raises(jres.IncompatibleCheckpointError, match=re.escape(refused)):
        jres.restore_checkpoint(make_ref(), j_path)


def test_map_list_states_through_a_fake_two_rank_sync():
    """MAP's per-image host lists (``dist_reduce_fx=None``) under one fake two-rank ``dist_sync_fn``: the JAX
    package flattens the gathered lists and then stacks each state's elements, which ragged per-image arrays
    refuse (``ValueError``); the port keeps a list state gathered without a reduction as a list, so its
    synced lists are the two ranks' per-image lists in rank order and its compute equals the JAX package's
    over both ranks' images in one stream. A real process group cannot carry the host lists in either
    package (the port's gather concatenates tensors)."""
    images, to_torch = _map_pair()
    local_p, peer_p = td.MeanAveragePrecision(device="cpu"), td.MeanAveragePrecision(device="cpu")
    local_j, peer_j = jd.MeanAveragePrecision(), jd.MeanAveragePrecision()
    for m, part in ((local_p, images[:3]), (peer_p, images[3:])):
        m.update([to_torch(p) for p, _ in part], [to_torch(t) for _, t in part])
    for m, part in ((local_j, images[:3]), (peer_j, images[3:])):
        m.update([p for p, _ in part], [t for _, t in part])

    def two_ranks(peer):
        names = list(peer._reductions)
        return lambda states, group: [[local, list(peer.metric_state[n])] for local, n in zip(states, names)]

    with pytest.raises(ValueError, match="same shape"):
        local_j.sync(dist_sync_fn=two_ranks(peer_j), distributed_available=True)
    local_p.sync(dist_sync_fn=two_ranks(peer_p), distributed_available=True)
    single = jd.MeanAveragePrecision()
    single.update([p for p, _ in images], [t for _, t in images])
    for key in ("detection_box", "detection_score", "detection_label", "gt_box", "gt_label", "gt_crowd"):
        got, want = local_p.metric_state[key], single.metric_state[key]
        assert len(got) == len(want) == len(images), key
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=key)
    assert local_p.metric_state["gt_area"] == [None] * len(images)
    got, want = local_p._compute_impl(), single.compute()
    for key in ("map", "map_50", "map_75", "mar_100", "map_small", "map_large"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=VALUE_RTOL, err_msg=key)
    local_p.unsync()
    assert len(local_p.detection_box) == 3


def test_a_real_gather_cannot_carry_map_host_lists(tmp_path):
    import torch.distributed as dist

    from metrics_tpu_torch.parallel.sync import gather_all_states

    images, to_torch = _map_pair(2)
    m = td.MeanAveragePrecision(device="cpu")
    m.update([to_torch(p) for p, _ in images], [to_torch(t) for _, t in images])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        with pytest.raises(TypeError):
            gather_all_states([m.detection_box], None)
    finally:
        dist.destroy_process_group()
