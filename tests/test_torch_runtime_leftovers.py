"""The port's runtime leftovers against the JAX package's: ``rank_zero_info``/``rank_zero_debug``,
``to_categorical`` and ``allclose``, ``check_forward_full_state_property``, ``Metric.to_device``,
``Metric.state_fingerprint``, and plotting (``utils/plot.py``, ``Metric.plot``, ``MetricCollection.plot``).

Fingerprints are equal wherever the two packages' state types agree: float32 list and sum states in the
default regime, and the int64 counters of the float64 regime (``jax.enable_x64(True)`` against a float64
default); the JAX package's default counters are int32 where the port's are int64, so those digests differ,
as a test states. Plots are drawn under the Agg backend and compared primitive by primitive: every line's
data, label and style, the texts, the images, the limits and the axis labels; the numbers within rtol 1e-5,
since a drawn float32 score may be an ulp apart between the packages.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

import metrics_tpu.utils.checks as jchecks  # noqa: E402
import metrics_tpu.utils.data as jdata  # noqa: E402
import metrics_tpu.utils.plot as jplot  # noqa: E402
import metrics_tpu.utils.prints as jprints  # noqa: E402
import metrics_tpu_torch.utils.checks as tchecks  # noqa: E402
import metrics_tpu_torch.utils.data as tdata  # noqa: E402
import metrics_tpu_torch.utils.plot as tplot  # noqa: E402
import metrics_tpu_torch.utils.prints as tprints  # noqa: E402
from metrics_tpu import MetricCollection as JCollection  # noqa: E402
from metrics_tpu import aggregation as jagg  # noqa: E402
from metrics_tpu import classification as jcls  # noqa: E402
from metrics_tpu import clustering as jclu  # noqa: E402
from metrics_tpu import nominal as jnom  # noqa: E402
from metrics_tpu import regression as jreg  # noqa: E402
from metrics_tpu import shape as jshape  # noqa: E402
from metrics_tpu_torch import MetricCollection as TCollection  # noqa: E402
from metrics_tpu_torch import aggregation as tagg  # noqa: E402
from metrics_tpu_torch import classification as tcls  # noqa: E402
from metrics_tpu_torch import clustering as tclu  # noqa: E402
from metrics_tpu_torch import nominal as tnom  # noqa: E402
from metrics_tpu_torch import regression as treg  # noqa: E402
from metrics_tpu_torch import shape as tshape  # noqa: E402
from metrics_tpu_torch.interop import load_reference_state  # noqa: E402


# ----------------------------------------------------------------------------- prints
@pytest.mark.parametrize(("fn", "level"), [("rank_zero_info", logging.INFO), ("rank_zero_debug", logging.DEBUG)])
def test_rank_zero_logging_matches_reference(caplog, fn, level):
    caplog.set_level(logging.DEBUG)
    getattr(jprints, fn)("from the reference")
    getattr(tprints, fn)("from the port")
    records = [(r.name, r.levelno, r.getMessage()) for r in caplog.records if r.name.startswith("metrics_tpu")]
    assert records == [("metrics_tpu", level, "from the reference"), ("metrics_tpu_torch", level, "from the port")]


@pytest.mark.parametrize("fn", ["rank_zero_info", "rank_zero_debug"])
def test_rank_zero_logging_is_silent_off_rank_zero(caplog, monkeypatch, fn):
    caplog.set_level(logging.DEBUG)
    monkeypatch.setattr(tprints, "_process_index", lambda: 1)
    assert getattr(tprints, fn)("not on rank 0") is None
    assert not [r for r in caplog.records if r.name.startswith("metrics_tpu")]


# ----------------------------------------------------------------------------- data helpers
@pytest.mark.parametrize("dim", [0, 1, -1])
def test_to_categorical_matches_reference(dim):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 3, (5, 4, 3)).astype(np.float32)  # many ties: both take the first maximum
    got = tdata.to_categorical(torch.from_numpy(x), argmax_dim=dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdata.to_categorical(jnp.asarray(x), argmax_dim=dim)))


@pytest.mark.parametrize(
    ("a", "b"),
    [
        (np.array([1.0, 2.0], np.float32), np.array([1, 2], np.int32)),
        (np.array([1.0, 2.0], np.float32), np.array([1.0, 2.00001], np.float64)),
        (np.array([1.0, 2.0], np.float32), np.array([1.0, 2.1], np.float32)),
        (np.array([1, 2], np.int32), np.array([1.4, 2.0], np.float32)),
        (np.array([0.0, 1e-9], np.float32), np.array([1e-9, 0.0], np.float32)),
    ],
)
def test_allclose_matches_reference(a, b):
    assert tdata.allclose(torch.from_numpy(a), torch.from_numpy(b)) is jdata.allclose(jnp.asarray(a), jnp.asarray(b))


# ----------------------------------------------------------------------------- the forward-state check
@pytest.mark.parametrize(
    ("a", "b", "want"),
    [
        (np.ones(3), np.ones(3), True),
        (np.ones(3), np.zeros(3), False),
        ({"x": np.ones(2), "y": "s"}, {"x": np.ones(2), "y": "s"}, True),
        ({"x": np.ones(2)}, {"y": np.ones(2)}, False),
        ([np.ones(2), 1.0], [np.ones(2), 1.0], True),
        ([np.ones(2)], [np.ones(2), np.ones(2)], False),
        ("abc", "abc", True),
        (np.float32(1.0), np.float64(1.0 + 1e-7), True),
    ],
)
def test_allclose_recursive_matches_reference(a, b, want):
    def conv(x, as_array):
        if isinstance(x, dict):
            return {k: conv(v, as_array) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v, as_array) for v in x]
        return as_array(x) if isinstance(x, (np.ndarray, np.generic)) else x

    assert jchecks._allclose_recursive(conv(a, jnp.asarray), conv(b, jnp.asarray)) is want
    assert tchecks._allclose_recursive(conv(a, torch.as_tensor), conv(b, torch.as_tensor)) is want


def _confmat_inputs(as_array):
    rng = np.random.RandomState(7)
    return {"preds": as_array(rng.randint(0, 3, 100)), "target": as_array(rng.randint(0, 3, 100))}


def test_forward_check_runs_both_paths_and_times_them_as_reference(capsys):
    for mod, init, arr in ((jcls, {}, jnp.asarray), (tcls, {"device": "cpu"}, torch.from_numpy)):
        checks = jchecks if mod is jcls else tchecks
        result = checks.check_forward_full_state_property(
            mod.MulticlassConfusionMatrix, init_args={"num_classes": 3, "validate_args": False, **init},
            input_args=_confmat_inputs(arr), num_update_to_compare=(4, 8), reps=1)
        out = capsys.readouterr().out
        assert isinstance(result, bool)
        assert "Full state for 4 steps took" in out and "Partial state for 8 steps took" in out
        assert f"Recommended setting `full_state_update={not result}`" in out


def _resetting(base):
    class ResettingConfusionMatrix(base):
        def update(self, preds, target):
            super().update(preds, target)
            if float(self.confmat.sum()) > 20:  # later states depend on earlier ones
                self.reset()
    return ResettingConfusionMatrix


def test_forward_check_recommends_full_state_for_a_state_dependent_update_as_reference(capsys):
    inputs = {"preds": np.arange(10) % 3, "target": (np.arange(10) + 1) % 3}
    for mod, checks, init, arr in ((jcls, jchecks, {}, jnp.asarray), (tcls, tchecks, {"device": "cpu"},
                                                                      torch.from_numpy)):
        result = checks.check_forward_full_state_property(
            _resetting(mod.MulticlassConfusionMatrix), init_args={"num_classes": 3, "validate_args": False, **init},
            input_args={k: arr(v) for k, v in inputs.items()}, num_update_to_compare=(10, 20), reps=1)
        assert result is False
        assert "Recommended setting `full_state_update=True`" in capsys.readouterr().out


# ----------------------------------------------------------------------------- to_device
def _fed_mse(device="cpu"):
    m = treg.MeanSquaredError(device=device)
    m.update(torch.tensor([1.0, 2.0, 4.0]), torch.tensor([1.0, 3.0, 2.0]))
    return m


def test_to_device_moves_every_state_and_default_and_keeps_going():
    m = tagg.CatMetric(device="cpu")
    m.update(torch.tensor([1.0, 2.0]))
    before = list(m.value)
    assert m.to_device("cpu") is m
    assert m.device == torch.device("cpu") and all(v.device.type == "cpu" for v in m.value)
    assert [torch.equal(a, b) for a, b in zip(m.value, before)] == [True]
    m.update(torch.tensor([3.0]))
    assert torch.equal(m.compute(), torch.tensor([1.0, 2.0, 3.0]))
    mse = _fed_mse()
    mse.to_device(torch.device("cpu"))
    mse.update(torch.tensor([0.0]), torch.tensor([2.0]))
    ref = jreg.MeanSquaredError()
    ref.update(jnp.asarray([1.0, 2.0, 4.0]), jnp.asarray([1.0, 3.0, 2.0]))
    ref.to_device(jax.devices("cpu")[0])
    ref.update(jnp.asarray([0.0]), jnp.asarray([2.0]))
    assert float(mse.compute()) == float(ref.compute()) == 2.25


def test_to_device_to_a_missing_card_raises_and_leaves_the_metric_as_it_was(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _fed_mse()
    state = dict(m.metric_state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.to_device("cuda")
    assert m.device == torch.device("cpu")
    assert all(m.metric_state[k] is v for k, v in state.items())


def test_to_device_keeps_compute_on_cpu_list_states_on_the_cpu():
    m = tagg.CatMetric(device="cpu", compute_on_cpu=True)
    m.update(torch.tensor([1.0]))
    kept = m.value[0]
    m.to_device("cpu")
    assert m.value[0] is kept


def test_to_device_of_a_wrapper_moves_its_children():
    from metrics_tpu_torch.wrappers import MinMaxMetric

    w = MinMaxMetric(treg.MeanSquaredError(device="cpu"))
    w.update(torch.tensor([1.0, 2.0]), torch.tensor([0.0, 2.0]))
    moved = []
    original = treg.MeanSquaredError.to_device

    def spy(self, device):
        moved.append(type(self).__name__)
        return original(self, device)

    treg.MeanSquaredError.to_device = spy
    try:
        assert w.to_device("cpu") is w
    finally:
        treg.MeanSquaredError.to_device = original
    assert moved == ["MeanSquaredError"]
    assert float(w.compute()["raw"]) == 0.5


# ----------------------------------------------------------------------------- state_fingerprint
def _twins(seed):
    """(port metric, JAX metric) pairs fed the same float32 inputs, whose states are float32 in both."""
    rng = np.random.RandomState(seed)
    labels_p = rng.randint(0, 4, 30).astype(np.float32)
    labels_t = rng.randint(0, 3, 30).astype(np.float32)
    data = rng.randn(30, 4).astype(np.float32)
    probs = rng.rand(10, 3, 4).astype(np.float32)
    cases = [
        (tclu.MutualInfoScore(device="cpu"), jclu.MutualInfoScore(), (labels_p, labels_t)),
        (tclu.CalinskiHarabaszScore(device="cpu"), jclu.CalinskiHarabaszScore(), (data, labels_t)),
        (tnom.TheilsU(num_classes=4, device="cpu"), jnom.TheilsU(num_classes=4), (labels_p, labels_t)),
        (tnom.FleissKappa(mode="probs", device="cpu"), jnom.FleissKappa(mode="probs"), (probs,)),
        (tagg.CatMetric(device="cpu"), jagg.CatMetric(), (labels_p,)),
    ]
    for port, ref, args in cases:
        for i in range(2):
            port.update(*(torch.from_numpy(a[i::2]) for a in args))
            ref.update(*(jnp.asarray(a[i::2]) for a in args))
    return cases


@pytest.mark.parametrize("index", range(5))
def test_fingerprint_equals_reference_where_the_state_types_agree(index):
    port, ref, _ = _twins(0)[index]
    assert port.state_fingerprint() == ref.state_fingerprint()


@pytest.mark.parametrize("index", range(5))
def test_fingerprint_tells_states_apart(index):
    port, _, args = _twins(1)[index]
    digest = port.state_fingerprint()
    twin = port.clone()
    assert twin.state_fingerprint() == digest
    twin.update(*(torch.from_numpy(a[:1]) for a in args))
    assert twin.state_fingerprint() != digest
    twin.reset()
    assert twin.state_fingerprint() != digest


def test_fingerprint_in_the_float64_regime_equals_reference():
    """Under x64 the JAX package's counters are int64 and its sums float64, as the port's under a float64
    default: the digests agree (inputs of small integers keep the sums exact in both)."""
    a = np.array([[[0.0, 1.0, 2.0], [1.0, 0.0, 2.0], [2.0, 2.0, 0.0], [0.0, 0.0, 1.0]]])
    b = a[:, ::-1].copy() * 2
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        port_mse, port_pd = treg.MeanSquaredError(device="cpu"), tshape.ProcrustesDisparity(device="cpu")
        port_mse.update(torch.tensor([1.0, 2.0, 4.0]), torch.tensor([1.0, 3.0, 2.0]))
        port_pd.update(torch.from_numpy(a), torch.from_numpy(b))
        port_digests = [port_mse.state_fingerprint(), port_pd.state_fingerprint()]
    finally:
        torch.set_default_dtype(previous)
    with jax.enable_x64(True):
        ref_mse, ref_pd = jreg.MeanSquaredError(), jshape.ProcrustesDisparity()
        ref_mse.update(jnp.asarray([1.0, 2.0, 4.0]), jnp.asarray([1.0, 3.0, 2.0]))
        ref_pd.update(jnp.asarray(a), jnp.asarray(b))
        ref_digests = [ref_mse.state_fingerprint(), ref_pd.state_fingerprint()]
    assert float(port_pd.disparity) == float(ref_pd.disparity)
    assert port_digests == ref_digests


def test_fingerprint_differs_from_reference_by_the_counter_type_in_the_default_regime():
    """The JAX package's default counters are int32, the port's int64: same values, other digests."""
    port, ref = _fed_mse(), jreg.MeanSquaredError()
    ref.update(jnp.asarray([1.0, 2.0, 4.0]), jnp.asarray([1.0, 3.0, 2.0]))
    assert np.asarray(ref.total).dtype == np.int32 and port.total.dtype == torch.int64
    assert float(port.sum_squared_error) == float(ref.sum_squared_error)
    assert port.state_fingerprint() != ref.state_fingerprint()


def test_fingerprint_of_bfloat16_states_equals_reference():
    port, ref = treg.MeanSquaredError(device="cpu"), jreg.MeanSquaredError()
    port.update(torch.tensor([1.0, 2.0]), torch.tensor([0.0, 2.0]))
    ref.update(jnp.asarray([1.0, 2.0]), jnp.asarray([0.0, 2.0]))
    port.half()
    ref.half()
    port.total = port.total.to(torch.int32)  # the JAX package's x32 counter type, so only bfloat16 differs
    assert port.sum_squared_error.dtype == torch.bfloat16
    assert port.state_fingerprint() == ref.state_fingerprint()


def test_fingerprint_survives_a_carried_state():
    ref = jclu.AdjustedRandScore()
    ref.update(jnp.asarray(np.array([0.0, 1.0, 1.0], np.float32)), jnp.asarray(np.array([1.0, 1.0, 0.0], np.float32)))
    ref.persistent(True)
    port = load_reference_state(tclu.AdjustedRandScore(device="cpu"), ref.state_dict())
    assert port.state_fingerprint() == ref.state_fingerprint()


# ----------------------------------------------------------------------------- plotting
def _drawn(ax):
    """What an axis shows: lines (data, label, style), collections' segments, texts, images, limits, labels."""
    lines = [(np.asarray(l.get_xdata(), float).tolist(), np.asarray(l.get_ydata(), float).tolist(), l.get_label(),
              l.get_linestyle(), l.get_marker()) for l in ax.get_lines()]
    segments = [np.round(np.asarray(s), 6).tolist() for c in ax.collections if hasattr(c, "get_segments")
                for s in c.get_segments()]
    texts = [(t.get_text(), np.round(np.asarray(t.get_position(), float), 6).tolist()) for t in ax.texts]
    images = [np.asarray(im.get_array()).tolist() for im in ax.images]
    legend = ax.get_legend()
    return {"lines": lines, "segments": segments, "texts": texts, "images": images,
            "ylim": np.round(ax.get_ylim(), 6).tolist(), "xlim": np.round(ax.get_xlim(), 6).tolist(),
            "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(), "title": ax.get_title(),
            "xvisible": ax.get_xaxis().get_visible(),
            "legend": [t.get_text() for t in legend.get_texts()] if legend else None}


def _alike(a, b, path="axis"):
    """Equal structure and strings; numbers within rtol 1e-5 (the drawn values are float32 results, a few of
    them an ulp apart between the packages)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _alike(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _alike(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _same_drawing(port_result, ref_result):
    pa = port_result[1] if isinstance(port_result, tuple) else port_result
    ra = ref_result[1] if isinstance(ref_result, tuple) else ref_result
    pa, ra = np.atleast_1d(np.asarray(pa, dtype=object)), np.atleast_1d(np.asarray(ra, dtype=object))
    assert len(pa) == len(ra)
    for a, b in zip(pa, ra):
        _alike(_drawn(a), _drawn(b))
    plt.close("all")


PLOT_VALUES = [
    ("scalar", np.float32(0.75)),
    ("vector", np.array([0.2, 0.5, 0.9], np.float32)),
    ("series", [np.float32(v) for v in (0.1, 0.4, 0.3)]),
    ("series of vectors", [np.array([0.1, 0.2], np.float32), np.array([0.3, 0.1], np.float32)]),
    ("dict", {"a": np.float32(0.3), "b": np.array([0.1, 0.2, 0.6], np.float32)}),
    ("series of dicts", [{"a": np.float32(0.3), "b": np.float32(0.1)}, {"a": np.float32(0.5), "b": np.float32(0.2)}]),
]


def _as(value, as_array):
    if isinstance(value, dict):
        return {k: _as(v, as_array) for k, v in value.items()}
    if isinstance(value, list):
        return [_as(v, as_array) for v in value]
    return as_array(np.asarray(value))


@pytest.mark.parametrize("bounds", [(None, None, None), (0.0, 1.0, True), (0.0, None, False)])
@pytest.mark.parametrize(("kind", "value"), PLOT_VALUES, ids=[k for k, _ in PLOT_VALUES])
def test_plot_single_or_multi_val_draws_as_reference(kind, value, bounds):
    lower, upper, higher = bounds
    kw = {"higher_is_better": higher, "lower_bound": lower, "upper_bound": upper, "legend_name": "cls",
          "name": "Metric"}
    _same_drawing(tplot.plot_single_or_multi_val(_as(value, torch.from_numpy), **kw),
                  jplot.plot_single_or_multi_val(_as(value, jnp.asarray), **kw))


@pytest.mark.parametrize("labels", [None, ["x", "y", "z"]])
@pytest.mark.parametrize("shape", [(3, 3), (3, 2, 2)])
def test_plot_confusion_matrix_draws_as_reference(shape, labels):
    confmat = np.random.RandomState(1).randint(0, 9, shape)
    _same_drawing(tplot.plot_confusion_matrix(torch.from_numpy(confmat), labels=labels),
                  jplot.plot_confusion_matrix(jnp.asarray(confmat), labels=labels))


def test_plot_curve_draws_as_reference():
    x = np.linspace(0, 1, 6).astype(np.float32)
    y = np.sqrt(x)
    kw = {"label_names": ("FPR", "TPR"), "name": "ROC"}
    _same_drawing(tplot.plot_curve((torch.from_numpy(x), torch.from_numpy(y)), score=torch.tensor(0.6), **kw),
                  jplot.plot_curve((jnp.asarray(x), jnp.asarray(y)), score=jnp.asarray(0.6), **kw))
    ragged = ([x[:3], x], [y[:3], y])
    _same_drawing(tplot.plot_curve(tuple([torch.from_numpy(a) for a in part] for part in ragged)),
                  jplot.plot_curve(tuple([jnp.asarray(a) for a in part] for part in ragged)))
    stacked = (np.stack([x, x]), np.stack([y, y ** 2]))
    _same_drawing(tplot.plot_curve(tuple(torch.from_numpy(a) for a in stacked), legend_name="label"),
                  jplot.plot_curve(tuple(jnp.asarray(a) for a in stacked), legend_name="label"))


def _plot_pairs():
    rng = np.random.RandomState(2)
    p, t = rng.randint(0, 3, 40), rng.randint(0, 3, 40)  # small integers: MSE's sums are exact in both
    pairs = [(tclu.AdjustedRandScore(device="cpu"), jclu.AdjustedRandScore()),
             (tnom.CramersV(num_classes=3, device="cpu"), jnom.CramersV(num_classes=3)),
             (treg.MeanSquaredError(device="cpu"), jreg.MeanSquaredError())]
    for port, ref in pairs:
        port.update(torch.from_numpy(p.astype(np.float32)), torch.from_numpy(t.astype(np.float32)))
        ref.update(jnp.asarray(p.astype(np.float32)), jnp.asarray(t.astype(np.float32)))
    return pairs


@pytest.mark.parametrize("index", range(3))
def test_metric_plot_draws_as_reference(index):
    port, ref = _plot_pairs()[index]
    _same_drawing(port.plot(), ref.plot())
    values = [np.float32(0.2), np.float32(0.4)]
    _same_drawing(port.plot([torch.tensor(v) for v in values]), ref.plot([jnp.asarray(v) for v in values]))
    fig, ax = plt.subplots()
    assert port.plot(ax=ax)[1] is ax
    plt.close("all")


@pytest.mark.parametrize("together", [False, True])
def test_collection_plot_draws_as_reference(together):
    rng = np.random.RandomState(3)
    # quarter integers: the sums of errors are exact in both packages, whatever their order
    p, t = (rng.randint(0, 8, 30) / 4).astype(np.float32), (rng.randint(0, 8, 30) / 4).astype(np.float32)
    port = TCollection([treg.MeanSquaredError(device="cpu"), treg.MeanAbsoluteError(device="cpu")])
    ref = JCollection([jreg.MeanSquaredError(), jreg.MeanAbsoluteError()])
    port.update(torch.from_numpy(p), torch.from_numpy(t))
    ref.update(jnp.asarray(p), jnp.asarray(t))
    got, want = port.plot(together=together), ref.plot(together=together)
    if together:
        _same_drawing(got, want)
    else:
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same_drawing(g, w)
    with pytest.raises(ValueError, match="together"):
        port.plot(together="yes")
    with pytest.raises(ValueError, match="sequence of matplotlib axis"):
        port.plot(ax=plt.subplots()[1])
    plt.close("all")


def test_plot_without_matplotlib_raises_the_reference_error(monkeypatch):
    monkeypatch.setattr(tplot, "_MATPLOTLIB_AVAILABLE", False)
    monkeypatch.setattr(jplot, "_MATPLOTLIB_AVAILABLE", False)
    port, ref = _plot_pairs()[0]
    with pytest.raises(ModuleNotFoundError) as want:
        ref.plot()
    with pytest.raises(ModuleNotFoundError) as got:
        port.plot()
    assert str(got.value) == str(want.value)
    for fn in (tplot.plot_confusion_matrix, tplot.plot_curve):
        with pytest.raises(ModuleNotFoundError, match="matplotlib"):
            fn((torch.zeros(2), torch.zeros(2)))


def _port_modules():
    import pkgutil

    import metrics_tpu_torch

    return sorted(info.name for info in pkgutil.walk_packages(metrics_tpu_torch.__path__, "metrics_tpu_torch.")
                  if ".ops" not in info.name)


@pytest.mark.parametrize("module", _port_modules())
def test_every_class_plots_with_the_reference_bounds_and_legend(module):
    """Each port class has the plot bounds, legend name and direction of its JAX counterpart, so that
    ``Metric.plot`` draws the same figure."""
    import importlib
    import inspect

    from metrics_tpu_torch.metric import Metric

    port_mod = importlib.import_module(module)
    try:
        ref_mod = importlib.import_module("metrics_tpu" + module[len("metrics_tpu_torch"):])
    except ImportError:
        return
    for name, cls in vars(port_mod).items():
        ref_cls = getattr(ref_mod, name, None)
        if not (inspect.isclass(cls) and issubclass(cls, Metric) and cls.__module__ == module
                and inspect.isclass(ref_cls)):
            continue
        for attr in ("plot_lower_bound", "plot_upper_bound", "plot_legend_name", "higher_is_better"):
            assert getattr(cls, attr) == getattr(ref_cls, attr, None), (name, attr)


def _classification_pair(name, kwargs):
    rng = np.random.RandomState(5)
    port, ref = getattr(tcls, name)(device="cpu", **kwargs), getattr(jcls, name)(**kwargs)
    if name.startswith("Binary"):
        p, t = rng.rand(60).astype(np.float32), rng.randint(0, 2, 60)
    elif name.startswith("Multiclass"):
        p, t = rng.rand(60, 3).astype(np.float32), rng.randint(0, 3, 60)
    else:
        p, t = rng.rand(60, 3).astype(np.float32), rng.randint(0, 2, (60, 3))
    port.update(torch.from_numpy(p), torch.from_numpy(t))
    ref.update(jnp.asarray(p), jnp.asarray(t))
    return port, ref


PLOTTED_CLASSES = [
    ("MulticlassConfusionMatrix", {"num_classes": 3}, {"labels": ["a", "b", "c"]}),
    ("MultilabelConfusionMatrix", {"num_labels": 3}, {"add_text": False}),
    ("BinaryConfusionMatrix", {}, {}),
    ("BinaryPrecisionRecallCurve", {"thresholds": 11}, {"score": True}),
    ("MulticlassPrecisionRecallCurve", {"num_classes": 3, "thresholds": 11}, {}),
    ("BinaryROC", {"thresholds": 11}, {"score": True}),
    ("MultilabelROC", {"num_labels": 3, "thresholds": 11}, {}),
    ("BinaryAUROC", {"thresholds": 11}, {}),
    ("MulticlassJaccardIndex", {"num_classes": 3}, {}),
    ("MulticlassAccuracy", {"num_classes": 3, "average": None}, {}),
]


@pytest.mark.parametrize(("name", "kwargs", "plot_kwargs"), PLOTTED_CLASSES, ids=[c[0] for c in PLOTTED_CLASSES])
def test_classification_plots_draw_as_reference(name, kwargs, plot_kwargs):
    """Confusion matrices draw heatmaps, curves draw their lines (with the area under a single curve when
    ``score=True``), and the scalar metrics built on either draw the generic value plot, as in the JAX package."""
    port, ref = _classification_pair(name, kwargs)
    _same_drawing(port.plot(**plot_kwargs), ref.plot(**plot_kwargs))


def test_retrieval_curve_and_wrapper_plots_draw_as_reference():
    from metrics_tpu import retrieval as jret
    from metrics_tpu import wrappers as jwr
    from metrics_tpu_torch import retrieval as tret
    from metrics_tpu_torch import wrappers as twr

    rng = np.random.RandomState(6)
    idx, p, t = rng.randint(0, 5, 80), rng.rand(80).astype(np.float32), rng.randint(0, 2, 80)
    for name, kw in (("RetrievalPrecisionRecallCurve", {"max_k": 4}),
                     ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.3, "max_k": 4})):
        port, ref = getattr(tret, name)(device="cpu", **kw), getattr(jret, name)(**kw)
        port.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(idx))
        ref.update(jnp.asarray(p), jnp.asarray(t), indexes=jnp.asarray(idx))
        _same_drawing(port.plot(), ref.plot())
    q, y = (rng.randint(0, 8, 40) / 4).astype(np.float32), (rng.randint(0, 8, 40) / 4).astype(np.float32)
    port_tr = twr.MetricTracker(treg.MeanSquaredError(device="cpu"))
    ref_tr = jwr.MetricTracker(jreg.MeanSquaredError())
    for step in range(3):
        port_tr.increment()
        ref_tr.increment()
        port_tr.update(torch.from_numpy(q[step::3]), torch.from_numpy(y[step::3]))
        ref_tr.update(jnp.asarray(q[step::3]), jnp.asarray(y[step::3]))
    _same_drawing(port_tr.plot(), ref_tr.plot())
    port_mt = twr.MultitaskWrapper({"a": treg.MeanSquaredError(device="cpu"), "b": treg.MeanAbsoluteError(device="cpu")})
    ref_mt = jwr.MultitaskWrapper({"a": jreg.MeanSquaredError(), "b": jreg.MeanAbsoluteError()})
    port_mt.update({"a": torch.from_numpy(q), "b": torch.from_numpy(q)}, {"a": torch.from_numpy(y), "b": torch.from_numpy(y)})
    ref_mt.update({"a": jnp.asarray(q), "b": jnp.asarray(q)}, {"a": jnp.asarray(y), "b": jnp.asarray(y)})
    got, want = port_mt.plot(), ref_mt.plot()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same_drawing(g, w)
