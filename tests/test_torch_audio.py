"""The port's audio metrics against the JAX package's, on the same seeded inputs.

SNR, SI-SDR, SI-SNR, C-SI-SNR and SA-SDR are the same float32 steps summed in
another order: within ``DB_ATOL`` dB. SDR solves its Toeplitz systems with
another LU than XLA's: in the float64 regime (``jax.enable_x64(True)`` beside
torch's float64 default) within ``SDR64_RTOL``; in float32 within
``SDR32_ATOL`` dB on white-noise-like targets, whose systems are well
conditioned. Both packages load the diagonal with ``eps * max(acf[..., 0])``
over the whole batch, so a signal's SDR depends on its batch-mates (a
reference caveat, held here in both). PIT's permutations are equal and its
values at the inner metric's tolerance; from three speakers both solve the
assignment with scipy. STOI and ESTOI run the same float64 host steps and a
float32 device stage: within ``STOI_ATOL``. SRMR builds its filterbanks with
torch's float32 ``exp``/``cos`` where the JAX package has XLA's: within
``SRMR_RTOL``. The mel spectrograms are the same numpy code: equal. The gated
metrics raise the JAX package's ``ModuleNotFoundError`` without their packages.
The second half runs the JAX package's own STOI and mel-spectrogram tests
(``tests/audio/test_stoi_native.py``, ``tests/audio/test_melspec.py``, with
their independent oracles) on the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.audio as ja
import metrics_tpu.audio.gated as jgated
import metrics_tpu.functional.audio as jfa
import metrics_tpu.functional.audio.gated_fn as jgated_fn
import metrics_tpu.functional.audio.metrics as jmetrics
import metrics_tpu.functional.audio.melspec as jmel
import metrics_tpu_torch.audio as ta
import metrics_tpu_torch.audio.gated as tgated
import metrics_tpu_torch.functional.audio as tfa
import metrics_tpu_torch.functional.audio.gated_fn as tgated_fn
import metrics_tpu_torch.functional.audio.metrics as tmetrics
import metrics_tpu_torch.functional.audio.melspec as tmel
from metrics_tpu_torch.interop import load_reference_state
from tests.audio.test_melspec import _ind_filterbank, _ind_melspec
from tests.audio.test_stoi_native import _oracle_stoi, _speechlike

DB_ATOL = 1e-4
SDR64_RTOL = 1e-6
SDR32_ATOL = 0.01
STOI_ATOL = 1e-5
SRMR_RTOL = 1e-4
CPU = {"device": "cpu"}


def _signals(seed, shape=(3, 2, 800), noise=0.3):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal(shape).astype(np.float32)
    preds = (target + noise * rng.standard_normal(shape)).astype(np.float32)
    return preds, target


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, atol=DB_ATOL, rtol=0.0):
    got, want = _np(port), np.asarray(ref)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _both(name, *arrays, **kwargs):
    """(port, JAX package) results of the functional ``name`` on the same arrays."""
    port = getattr(tfa, name)(*(torch.from_numpy(a) for a in arrays), **kwargs)
    ref = getattr(jfa, name)(*(jnp.asarray(a) for a in arrays), **kwargs)
    return port, ref


# ----------------------------------------------------------------------------- the SNR family
@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("name", ["signal_noise_ratio", "scale_invariant_signal_distortion_ratio"])
def test_snr_and_si_sdr_within_atol(name, zero_mean):
    for seed in (0, 1):
        _close(*_both(name, *_signals(seed), zero_mean=zero_mean))


def test_si_snr_within_atol():
    _close(*_both("scale_invariant_signal_noise_ratio", *_signals(2)))


@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("scale_invariant", [False, True])
def test_sa_sdr_within_atol(scale_invariant, zero_mean):
    p, t = _signals(3)
    port = tfa.source_aggregated_signal_distortion_ratio(torch.from_numpy(p), torch.from_numpy(t), scale_invariant,
                                                         zero_mean)
    ref = jmetrics.source_aggregated_signal_distortion_ratio(jnp.asarray(p), jnp.asarray(t), scale_invariant,
                                                             zero_mean)
    _close(port, ref)


@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("form", ["complex", "real"])
def test_complex_si_snr_within_atol(form, zero_mean):
    p, t = _signals(4, shape=(2, 17, 20, 2))
    if form == "complex":
        p = (p[..., 0] + 1j * p[..., 1]).astype(np.complex64)
        t = (t[..., 0] + 1j * t[..., 1]).astype(np.complex64)
    port = tmetrics.complex_scale_invariant_signal_noise_ratio(torch.from_numpy(p), torch.from_numpy(t), zero_mean)
    ref = jmetrics.complex_scale_invariant_signal_noise_ratio(jnp.asarray(p), jnp.asarray(t), zero_mean)
    _close(port, ref)


def test_complex_si_snr_refuses_a_real_input_without_pairs_as_reference():
    with pytest.raises(RuntimeError) as port:
        tmetrics.complex_scale_invariant_signal_noise_ratio(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4))
    with pytest.raises(RuntimeError) as ref:
        jmetrics.complex_scale_invariant_signal_noise_ratio(jnp.zeros((2, 3, 4)), jnp.zeros((2, 3, 4)))
    assert str(port.value) == str(ref.value)


# ----------------------------------------------------------------------------- SDR
@pytest.mark.parametrize(("filter_length", "zero_mean", "load_diag"), [
    (512, False, None), (64, True, None), (16, False, 1e-3), (128, False, None)])
def test_sdr_float32_within_a_hundredth_of_a_db(filter_length, zero_mean, load_diag):
    p, t = _signals(5, shape=(2, 2, 2000))
    port, ref = _both("signal_distortion_ratio", p, t, filter_length=filter_length, zero_mean=zero_mean,
                      load_diag=load_diag)
    _close(port, ref, atol=SDR32_ATOL)


@pytest.mark.parametrize(("filter_length", "zero_mean", "load_diag"), [(512, False, None), (32, True, 1e-2)])
def test_sdr_float64_regime_within_rtol(filter_length, zero_mean, load_diag):
    p, t = _signals(6, shape=(3, 1500))
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        port = tfa.signal_distortion_ratio(torch.from_numpy(p), torch.from_numpy(t), None, filter_length, zero_mean,
                                           load_diag)
    finally:
        torch.set_default_dtype(previous)
    with jax.enable_x64(True):
        ref = np.asarray(jfa.signal_distortion_ratio(jnp.asarray(p), jnp.asarray(t), None, filter_length, zero_mean,
                                                     load_diag))
    _close(port, ref, atol=0.0, rtol=SDR64_RTOL)


def test_sdr_diagonal_loading_couples_the_batch_in_both_packages():
    """A low-rank target (a sum of two tones) alone, then beside a loud noise signal: the loading is eps times
    the batch's largest zero-lag autocorrelation, so the tone's SDR moves, by the same amount in both."""
    n = 2000
    tone = (np.sin(0.05 * np.arange(n)) + 0.5 * np.sin(0.31 * np.arange(n))).astype(np.float32)
    noisy_tone = (tone + 0.01 * np.random.default_rng(7).standard_normal(n)).astype(np.float32)
    loud = (300.0 * np.random.default_rng(8).standard_normal(n)).astype(np.float32)
    loud_pred = (loud + 30.0 * np.random.default_rng(9).standard_normal(n)).astype(np.float32)
    alone_t, alone_j = _both("signal_distortion_ratio", noisy_tone[None], tone[None], filter_length=64)
    pair_t, pair_j = _both("signal_distortion_ratio", np.stack([noisy_tone, loud_pred]), np.stack([tone, loud]),
                           filter_length=64)
    assert abs(float(alone_t[0]) - float(pair_t[0])) > 0.05
    assert abs(float(alone_j[0]) - float(pair_j[0])) > 0.05
    _close(pair_t, pair_j, atol=SDR32_ATOL)
    _close(alone_t, alone_j, atol=SDR32_ATOL)


def test_sdr_use_cg_iter_warns_as_reference():
    p, t = _signals(9, shape=(1, 500))
    with pytest.warns(UserWarning, match="`use_cg_iter` is ignored"):
        tfa.signal_distortion_ratio(torch.from_numpy(p), torch.from_numpy(t), use_cg_iter=10, filter_length=16)
    with pytest.warns(UserWarning, match="`use_cg_iter` is ignored"):
        jfa.signal_distortion_ratio(jnp.asarray(p), jnp.asarray(t), use_cg_iter=10, filter_length=16)


# ----------------------------------------------------------------------------- PIT
def _speakers(seed, spk, batch=4, n=300):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((batch, spk, n)).astype(np.float32)
    preds = np.stack([target[b, rng.permutation(spk)] for b in range(batch)])
    return (preds + 0.4 * rng.standard_normal(preds.shape)).astype(np.float32), target


@pytest.mark.parametrize("inner", ["scale_invariant_signal_distortion_ratio", "signal_noise_ratio"])
@pytest.mark.parametrize("eval_func", ["max", "min"])
@pytest.mark.parametrize("mode", ["speaker-wise", "permutation-wise"])
@pytest.mark.parametrize("spk", [2, 3])
def test_pit_permutations_equal_values_within_atol(spk, mode, eval_func, inner):
    p, t = _speakers(10 + spk, spk)
    best_t, perm_t = tfa.permutation_invariant_training(torch.from_numpy(p), torch.from_numpy(t),
                                                        getattr(tfa, inner), mode, eval_func)
    best_j, perm_j = jfa.permutation_invariant_training(jnp.asarray(p), jnp.asarray(t), getattr(jfa, inner), mode,
                                                        eval_func)
    _close(best_t, best_j)
    assert perm_t.dtype == torch.int32 and np.array_equal(perm_t.numpy(), np.asarray(perm_j))
    _close(tfa.pit_permutate(torch.from_numpy(p), perm_t), jfa.pit_permutate(jnp.asarray(p), perm_j), atol=0.0)


def test_pit_three_speakers_without_scipy_enumerates_and_warns(monkeypatch):
    import metrics_tpu.utils.imports as jimports

    monkeypatch.setattr(tmetrics, "_SCIPY_AVAILABLE", False)
    monkeypatch.setattr(jimports, "_SCIPY_AVAILABLE", False)
    p, t = _speakers(20, 3)
    with pytest.warns(UserWarning, match="recommend installing scipy"):
        best_t, perm_t = tfa.permutation_invariant_training(torch.from_numpy(p), torch.from_numpy(t),
                                                            tfa.scale_invariant_signal_distortion_ratio)
    with pytest.warns(UserWarning, match="recommend installing scipy"):
        best_j, perm_j = jfa.permutation_invariant_training(jnp.asarray(p), jnp.asarray(t),
                                                            jfa.scale_invariant_signal_distortion_ratio)
    _close(best_t, best_j)
    assert np.array_equal(perm_t.numpy(), np.asarray(perm_j))


def test_pit_first_best_wins_on_ties_as_reference():
    t = np.random.default_rng(21).standard_normal((2, 2, 100)).astype(np.float32)
    p = np.stack([t[:, 0], t[:, 0]], axis=1)  # both predictions the same source: two equal permutations
    _, perm_t = tfa.permutation_invariant_training(torch.from_numpy(p), torch.from_numpy(t), tfa.signal_noise_ratio)
    _, perm_j = jfa.permutation_invariant_training(jnp.asarray(p), jnp.asarray(t), jfa.signal_noise_ratio)
    assert np.array_equal(perm_t.numpy(), np.asarray(perm_j))


@pytest.mark.parametrize(("kwargs", "shape"), [({"eval_func": "mean"}, (2, 2, 10)),
                                               ({"mode": "both"}, (2, 2, 10)), ({}, (10,))])
def test_pit_errors_as_reference(kwargs, shape):
    with pytest.raises(ValueError) as port:
        tfa.permutation_invariant_training(torch.zeros(shape), torch.zeros(shape), tfa.signal_noise_ratio, **kwargs)
    with pytest.raises(ValueError) as ref:
        jfa.permutation_invariant_training(jnp.zeros(shape), jnp.zeros(shape), jfa.signal_noise_ratio, **kwargs)
    assert str(port.value) == str(ref.value)


# ----------------------------------------------------------------------------- STOI
def _stoi_pairs(seed, fs, seconds, batch=3):
    rng = np.random.RandomState(seed)
    n = int(fs * seconds)
    clean = np.stack([_speechlike(rng, n, fs) for _ in range(batch)])
    return clean + np.array([0.1, 0.7, 2.0][:batch])[:, None] * rng.randn(batch, n), clean


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("fs", [8000, 10000, 16000])
def test_stoi_within_atol(fs, extended):
    p, t = _stoi_pairs(30 + fs // 1000, fs, 1.5)
    port = tfa.short_time_objective_intelligibility(torch.from_numpy(p), torch.from_numpy(t), fs, extended)
    ref = jfa.short_time_objective_intelligibility(jnp.asarray(p), jnp.asarray(t), fs, extended)
    _close(port, ref, atol=STOI_ATOL)
    port_np = tfa.short_time_objective_intelligibility(p.reshape(3, 1, -1), t.reshape(3, 1, -1), fs, extended, **CPU)
    assert port_np.shape == (3, 1)


def test_stoi_too_short_signal_warns_and_gives_the_floor_in_a_batch():
    rng = np.random.RandomState(31)
    clean = np.stack([_speechlike(rng, 20000, 10000), rng.randn(20000)])
    clean[1, 1000:] = 0.0  # 1,000 samples of sound: fewer than 30 frames
    noisy = clean + 0.3 * rng.randn(*clean.shape)
    with pytest.warns(RuntimeWarning, match="384 ms"):
        port = tfa.short_time_objective_intelligibility(torch.from_numpy(noisy), torch.from_numpy(clean), 10000)
    with pytest.warns(RuntimeWarning, match="384 ms"):
        ref = jfa.short_time_objective_intelligibility(noisy, clean, 10000)
    _close(port, ref, atol=STOI_ATOL)
    assert float(port[1]) == np.float32(1e-5)


# ----------------------------------------------------------------------------- SRMR
@pytest.mark.parametrize(("fs", "norm", "kwargs"), [
    (8000, False, {}), (8000, True, {}), (16000, False, {"n_cochlear_filters": 12, "max_cf": 64.0}),
    (16000, True, {"low_freq": 200, "min_cf": 2})])
def test_srmr_within_rtol(fs, norm, kwargs):
    rng = np.random.default_rng(40)
    t = np.arange(fs) / fs
    x = np.stack([(1 + np.sin(2 * np.pi * f * t)) * rng.standard_normal(fs) for f in (4.0, 8.0, 16.0)])
    port = tfa.speech_reverberation_modulation_energy_ratio(torch.from_numpy(x), fs, norm=norm, **kwargs)
    ref = jfa.speech_reverberation_modulation_energy_ratio(jnp.asarray(x), fs, norm=norm, **kwargs)
    _close(port, ref, atol=0.0, rtol=SRMR_RTOL)
    one = tfa.speech_reverberation_modulation_energy_ratio(x[0], fs, norm=norm, **kwargs, **CPU)
    assert one.shape == () and abs(float(one) / float(port[0]) - 1) < SRMR_RTOL


def test_srmr_short_signal_and_fast_as_reference():
    x = np.random.default_rng(41).standard_normal((2, 1500))  # shorter than one 256 ms frame at 8 kHz
    _close(tfa.speech_reverberation_modulation_energy_ratio(torch.from_numpy(x), 8000),
           jfa.speech_reverberation_modulation_energy_ratio(jnp.asarray(x), 8000), atol=0.0, rtol=SRMR_RTOL)
    with pytest.raises(NotImplementedError, match="`fast=True`"):
        tfa.speech_reverberation_modulation_energy_ratio(torch.from_numpy(x), 8000, fast=True)
    with pytest.raises(NotImplementedError, match="`fast=True`"):
        jfa.speech_reverberation_modulation_energy_ratio(jnp.asarray(x), 8000, fast=True)


# ----------------------------------------------------------------------------- mel spectrograms
@pytest.mark.parametrize(("sr", "n_fft", "hop", "win", "n_mels", "fmax", "power", "pad_mode"), [
    (16000, 321, 160, 321, 120, None, 2.0, "constant"), (48000, 4096, 480, 960, 48, 20000.0, 1.0, "reflect")])
def test_melspec_equal_reference(sr, n_fft, hop, win, n_mels, fmax, power, pad_mode):
    y = np.random.default_rng(42).standard_normal((2, sr // 4))
    kwargs = dict(n_fft=n_fft, hop_length=hop, win_length=win, n_mels=n_mels, fmax=fmax, power=power,
                  pad_mode=pad_mode)
    got, want = tmel.melspectrogram(y, sr, **kwargs), jmel.melspectrogram(y, sr, **kwargs)
    assert got.tobytes() == want.tobytes()
    assert tmel.power_to_db(got, ref=1.0).tobytes() == jmel.power_to_db(want, ref=1.0).tobytes()
    assert tmel.amplitude_to_db(got, amin=1e-4).tobytes() == jmel.amplitude_to_db(want, amin=1e-4).tobytes()


def test_dnsmos_and_nisqa_featurization_equal_reference():
    rng = np.random.default_rng(43)
    seg = rng.standard_normal(int(9.01 * 16000)).astype(np.float32)
    assert tgated._dnsmos_melspec(seg[:-160], 16000).tobytes() == jgated._dnsmos_melspec(seg[:-160], 16000).tobytes()
    wav = rng.standard_normal(48000).astype(np.float32)
    (s_t, n_t), (s_j, n_j) = tgated._nisqa_features(wav, 48000), jgated._nisqa_features(wav, 48000)
    assert n_t == n_j and s_t.tobytes() == s_j.tobytes()
    assert tgated._resample(wav, 48000, 16000).tobytes() == jgated._resample(wav, 48000, 16000).tobytes()


# ----------------------------------------------------------------------------- the classes
CLASSES = {
    "SignalNoiseRatio": {"zero_mean": True}, "ScaleInvariantSignalDistortionRatio": {},
    "ScaleInvariantSignalNoiseRatio": {}, "ComplexScaleInvariantSignalNoiseRatio": {},
    "SignalDistortionRatio": {"filter_length": 64}, "SourceAggregatedSignalDistortionRatio": {"zero_mean": True},
    "PermutationInvariantTraining": {}, "PermutationInvariantTraining[3,min]": {"eval_func": "min"},
    "ShortTimeObjectiveIntelligibility": {"fs": 10000, "extended": True},
    "SpeechReverberationModulationEnergyRatio": {"fs": 8000, "norm": True},
}


def _make(case):
    cls = case.split("[")[0]
    kwargs = dict(CLASSES[case])
    if cls == "PermutationInvariantTraining":
        return (ta.PermutationInvariantTraining(tfa.scale_invariant_signal_distortion_ratio, zero_mean=True,
                                                **kwargs, **CPU),
                ja.PermutationInvariantTraining(jfa.scale_invariant_signal_distortion_ratio, zero_mean=True, **kwargs))
    return getattr(ta, cls)(**kwargs, **CPU), getattr(ja, cls)(**kwargs)


def _audio_inputs(case, seed):
    if case.startswith("PermutationInvariantTraining"):
        return _speakers(seed, 3 if "[3" in case else 2, batch=3)
    if case == "ComplexScaleInvariantSignalNoiseRatio":
        return _signals(seed, shape=(2, 9, 12, 2))
    if case == "ShortTimeObjectiveIntelligibility":
        p, t = _stoi_pairs(seed, 10000, 1.0, batch=2)
        return p.astype(np.float32), t.astype(np.float32)
    if case == "SpeechReverberationModulationEnergyRatio":
        return (_signals(seed, shape=(2, 4000))[0],)
    if case == "SourceAggregatedSignalDistortionRatio":
        return _signals(seed, shape=(2, 3, 500))
    return _signals(seed, shape=(3, 600))


def _tol(case):
    return {"SignalDistortionRatio": (SDR32_ATOL, 0.0), "ShortTimeObjectiveIntelligibility": (STOI_ATOL, 0.0),
            "SpeechReverberationModulationEnergyRatio": (0.0, SRMR_RTOL)}.get(case, (DB_ATOL, 0.0))


def _states(case, port, ref):
    atol, rtol = _tol(case)
    for key, value in ref.metric_state.items():
        got = port.metric_state[key]
        if key == "total":  # count_dtype(): int64 in the port, int32 under x32
            assert got.dtype == torch.int64 and int(got) == int(value)
        else:
            scale = max(1, int(port.metric_state["total"]))  # a sum of that many values within the tolerance
            _close(got, value, atol=atol * scale, rtol=rtol)


def _feed(m, batch, as_array):
    m.update(*(as_array(x) for x in batch))


@pytest.mark.parametrize("case", list(CLASSES))
def test_class_update_compute_forward_merge_reset_match_reference(case):
    port, ref = _make(case)
    atol, rtol = _tol(case)
    batches = [_audio_inputs(case, s) for s in (50, 51, 52)]
    for b in batches[:2]:
        _feed(port, b, torch.from_numpy)
        _feed(ref, b, jnp.asarray)
    _states(case, port, ref)
    _close(port.compute(), ref.compute(), atol, rtol)
    _close(port(*(torch.from_numpy(x) for x in batches[2])), ref(*(jnp.asarray(x) for x in batches[2])), atol, rtol)
    port2, ref2 = _make(case)
    _feed(port2, batches[0], torch.from_numpy)
    _feed(ref2, batches[0], jnp.asarray)
    port.merge_state(port2)
    ref.merge_state(ref2)
    _states(case, port, ref)
    _close(port.compute(), ref.compute(), atol, rtol)
    port.reset()
    assert float(port.sum_value) == 0.0 and int(port.total) == 0 and port.total.dtype == torch.int64


def _fake_sync(peers, as_array):
    def sync_fn(states, group):
        return [[local] + [as_array(np.asarray(p[i])) for p in peers] for i, local in enumerate(states)]
    return sync_fn


@pytest.mark.parametrize("case", ["ScaleInvariantSignalDistortionRatio", "SignalDistortionRatio",
                                  "PermutationInvariantTraining"])
def test_fake_sync_and_reference_stream_match_reference(case):
    port, ref = _make(case)
    _feed(port, _audio_inputs(case, 60), torch.from_numpy)
    _feed(ref, _audio_inputs(case, 60), jnp.asarray)
    peers_t, peers_j = [], []
    for seed in (61, 62):
        pt, pj = _make(case)
        _feed(pt, _audio_inputs(case, seed), torch.from_numpy)
        _feed(pj, _audio_inputs(case, seed), jnp.asarray)
        peers_t.append([v.numpy() for v in pt.metric_state.values()])
        peers_j.append([np.asarray(v) for v in pj.metric_state.values()])
    port.sync(dist_sync_fn=_fake_sync(peers_t, torch.from_numpy), distributed_available=True)
    ref.sync(dist_sync_fn=_fake_sync(peers_j, jnp.asarray), distributed_available=True)
    _states(case, port, ref)
    port.unsync()
    # a stream started in the JAX package resumes in the port
    fresh, ref3 = _make(case)
    ref3.persistent(True)
    _feed(ref3, _audio_inputs(case, 63), jnp.asarray)
    load_reference_state(fresh, ref3.state_dict())
    _feed(fresh, _audio_inputs(case, 64), torch.from_numpy)
    _feed(ref3, _audio_inputs(case, 64), jnp.asarray)
    _states(case, fresh, ref3)
    _close(fresh.compute(), ref3.compute(), *_tol(case))


def test_audio_states_keep_the_reference_types():
    for case in CLASSES:
        port, _ = _make(case)
        assert port.sum_value.dtype == torch.float32 and port.total.dtype == torch.int64, case


def test_sa_sdr_scale_invariant_must_be_a_bool_as_reference():
    with pytest.raises(ValueError, match="to be a bool"):
        ta.SourceAggregatedSignalDistortionRatio(scale_invariant=1, **CPU)
    with pytest.raises(ValueError, match="to be a bool"):
        ja.SourceAggregatedSignalDistortionRatio(scale_invariant=1)


def test_without_a_card_the_audio_classes_need_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for case in CLASSES:
        kwargs = dict(CLASSES[case])
        cls = getattr(ta, case.split("[")[0])
        args = (tfa.signal_noise_ratio,) if cls is ta.PermutationInvariantTraining else ()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(*args, **kwargs)
        cls(*args, **kwargs, **CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfa.short_time_objective_intelligibility(np.zeros(3000), np.zeros(3000), 10000)


# ----------------------------------------------------------------------------- the gates
GATED = [("PerceptualEvaluationSpeechQuality", {"fs": 16000, "mode": "wb"}, "_PESQ_AVAILABLE"),
         ("DeepNoiseSuppressionMeanOpinionScore", {"fs": 16000}, "_ONNXRUNTIME_AVAILABLE"),
         ("NonIntrusiveSpeechQualityAssessment", {"fs": 16000}, "_ONNXRUNTIME_AVAILABLE")]
GATED_FNS = [("perceptual_evaluation_speech_quality", (np.zeros(8000), np.zeros(8000), 16000, "wb"),
              "_PESQ_AVAILABLE"),
             ("deep_noise_suppression_mean_opinion_score", (np.zeros(8000), 16000), "_ONNXRUNTIME_AVAILABLE"),
             ("non_intrusive_speech_quality_assessment", (np.zeros(8000), 16000), "_ONNXRUNTIME_AVAILABLE")]


@pytest.mark.parametrize(("name", "kwargs", "flag"), GATED)
def test_gated_classes_raise_the_reference_error(monkeypatch, name, kwargs, flag):
    monkeypatch.setattr(tgated, flag, False)
    monkeypatch.setattr(jgated, flag, False)
    with pytest.raises(ModuleNotFoundError) as port:
        getattr(ta, name)(**kwargs, **CPU)
    with pytest.raises(ModuleNotFoundError) as ref:
        getattr(ja, name)(**kwargs)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize(("name", "args", "flag"), GATED_FNS)
def test_gated_functions_raise_the_reference_error(monkeypatch, name, args, flag):
    monkeypatch.setattr(tgated_fn, flag, False)
    monkeypatch.setattr(jgated_fn, flag, False)
    with pytest.raises(ModuleNotFoundError) as port:
        getattr(tfa, name)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    with pytest.raises(ModuleNotFoundError) as ref:
        getattr(jfa, name)(*args)
    assert str(port.value) == str(ref.value)


def test_gates_follow_the_installed_packages():
    import importlib.util

    assert tgated._PESQ_AVAILABLE == (importlib.util.find_spec("pesq") is not None)
    assert tgated._ONNXRUNTIME_AVAILABLE == (importlib.util.find_spec("onnxruntime") is not None)
    if not tgated._PESQ_AVAILABLE:
        with pytest.raises(ModuleNotFoundError, match="requires that `pesq` is installed"):
            ta.PerceptualEvaluationSpeechQuality(16000, "wb", **CPU)
    if not tgated._ONNXRUNTIME_AVAILABLE:
        with pytest.raises(ModuleNotFoundError, match="requires that `onnxruntime` is installed"):
            ta.DeepNoiseSuppressionMeanOpinionScore(16000, **CPU)


def test_local_model_path_never_downloads(monkeypatch, tmp_path):
    monkeypatch.setenv("METRICS_TPU_WEIGHTS", str(tmp_path))
    with pytest.raises(ModuleNotFoundError, match="never downloads"):
        tgated._local_model_path("nisqa.onnx", "NISQA")
    (tmp_path / "nisqa.onnx").write_bytes(b"")
    assert tgated._local_model_path("nisqa.onnx", "NISQA") == str(tmp_path / "nisqa.onnx")


# ----------------------------------------------------------------------------- the JAX package's STOI and mel tests, on the port
@pytest.mark.parametrize("fs", [8000, 10000, 16000])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("seconds", [1.0, 2.5])
def test_native_stoi_matches_independent_oracle(fs, extended, seconds):
    """The oracle's float64 against the port's float32 device stage, within 1e-6 as the JAX package's own test
    holds its float32 stage."""
    rng = np.random.RandomState(fs + int(seconds * 10) + extended)
    n = int(fs * seconds)
    clean = _speechlike(rng, n, fs)
    for snr_scale in (0.1, 0.7, 2.0):
        degraded = clean + snr_scale * rng.randn(n)
        got = tfa.stoi.stoi_native(degraded, clean, fs, extended=extended, **CPU)
        want = _oracle_stoi(degraded, clean, fs, extended=extended)
        assert got == pytest.approx(want, abs=1e-6), (fs, extended, seconds, snr_scale)


def test_identity_is_one_and_noise_degrades_monotonically():
    rng = np.random.RandomState(0)
    clean = _speechlike(rng, 32000, 16000)
    assert tfa.stoi.stoi_native(clean, clean, 16000, **CPU) == pytest.approx(1.0, abs=1e-6)
    scores = [tfa.stoi.stoi_native(clean + s * rng.randn(32000), clean, 16000, **CPU) for s in (0.1, 0.5, 2.0)]
    assert scores[0] > scores[1] > scores[2]


def test_too_short_signal_warns_and_returns_floor():
    short = np.random.RandomState(1).randn(1000)
    with pytest.warns(RuntimeWarning, match="384 ms"):
        assert tfa.stoi.stoi_native(short, short, 10000, **CPU) == 1e-5


def test_batched_functional_shape_and_values():
    rng = np.random.RandomState(2)
    clean = _speechlike(rng, 20000, 10000)
    noisy = clean + 0.5 * rng.randn(20000)
    out = tfa.short_time_objective_intelligibility(np.stack([clean, noisy]), np.stack([clean, clean]), 10000, **CPU)
    assert out.shape == (2,)
    assert float(out[0]) == pytest.approx(1.0, abs=1e-6)
    assert float(out[1]) == pytest.approx(tfa.stoi.stoi_native(noisy, clean, 10000, **CPU), abs=1e-6)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="same shape"):
        tfa.stoi.stoi_native(np.zeros(100), np.zeros(200), 10000, **CPU)
    with pytest.raises(ValueError, match="same shape"):
        tfa.short_time_objective_intelligibility(np.zeros((2, 100)), np.zeros((3, 100)), 10000, **CPU)


def test_modular_metric_runs_without_pystoi():
    rng = np.random.RandomState(3)
    clean = _speechlike(rng, 20000, 10000)
    noisy = clean + 0.4 * rng.randn(20000)
    m = ta.ShortTimeObjectiveIntelligibility(fs=10000, **CPU)
    m.update(torch.from_numpy(np.stack([clean, noisy])), torch.from_numpy(np.stack([clean, clean])))
    expected = (1.0 + tfa.stoi.stoi_native(noisy, clean, 10000, **CPU)) / 2
    assert float(m.compute()) == pytest.approx(expected, abs=1e-5)
    ext = ta.ShortTimeObjectiveIntelligibility(fs=10000, extended=True, **CPU)
    ext.update(torch.from_numpy(noisy), torch.from_numpy(clean))
    assert float(ext.compute()) == pytest.approx(tfa.stoi.stoi_native(noisy, clean, 10000, extended=True, **CPU),
                                                 abs=1e-5)


def test_slaney_mel_scale_golden_points():
    assert tmel.mel_frequencies(3, 0.0, 1000.0) == pytest.approx([0.0, 500.0, 1000.0])
    np.testing.assert_allclose(tmel.mel_frequencies(2, 0.0, 1000.0)[1], 1000.0)
    f = tmel.mel_frequencies(17, 0.0, float(1000.0 * 6.4 ** (1.0 / 27.0)))
    np.testing.assert_allclose(f[-2], 1000.0, rtol=1e-9)


def test_power_to_db_golden():
    np.testing.assert_allclose(tmel.power_to_db(np.array([1.0, 0.1, 1e-12]), ref=1.0), [0.0, -10.0, -80.0])
    np.testing.assert_allclose(tmel.amplitude_to_db(np.array([1.0, 0.1]), ref=1.0, amin=1e-4), [0.0, -20.0])
    np.testing.assert_allclose(tmel.amplitude_to_db(np.array([1.0, 1e-6]), ref=1.0, amin=1e-4, top_db=None),
                               [0.0, -80.0])


def test_hann_window_matches_scipy():
    from scipy.signal import get_window

    for win, n_fft in ((321, 321), (960, 4096)):
        w = tmel.hann_periodic(win, n_fft)
        lpad = (n_fft - win) // 2
        np.testing.assert_allclose(w[lpad: lpad + win], get_window("hann", win, fftbins=True), atol=1e-12)
        assert np.all(w[:lpad] == 0) and np.all(w[lpad + win:] == 0)


@pytest.mark.parametrize(("sr", "n_fft", "n_mels", "fmax"), [(16000, 321, 120, None), (48000, 4096, 48, 20000.0)])
def test_filterbank_matches_independent(sr, n_fft, n_mels, fmax):
    ours = tmel.mel_filterbank(sr, n_fft, n_mels, fmax=fmax)
    assert ours.shape == (n_mels, 1 + n_fft // 2)
    np.testing.assert_allclose(ours, _ind_filterbank(sr, n_fft, n_mels, fmax=fmax), atol=1e-12)


@pytest.mark.parametrize(("sr", "n_fft", "hop", "win", "n_mels", "fmax", "power", "pad_mode"), [
    (16000, 321, 160, 321, 120, None, 2.0, "constant"), (48000, 4096, 480, 960, 48, 20000.0, 1.0, "reflect")])
def test_melspectrogram_matches_independent(sr, n_fft, hop, win, n_mels, fmax, power, pad_mode):
    y = np.random.RandomState(11).randn(sr // 4)
    ours = tmel.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop, win_length=win, n_mels=n_mels, fmax=fmax,
                               power=power, pad_mode=pad_mode)
    ind = _ind_melspec(y, sr, n_fft, hop, win, n_mels, fmax if fmax else sr / 2.0, power, pad_mode)
    np.testing.assert_allclose(ours, ind, rtol=1e-9, atol=1e-12)


def test_sine_peaks_in_matching_mel_band():
    sr, f0 = 16000, 440.0
    t = np.arange(sr) / sr
    mel = tmel.melspectrogram(np.sin(2 * np.pi * f0 * t), sr, n_fft=321, hop_length=160, n_mels=120)
    centers = tmel.mel_frequencies(122, 0.0, sr / 2.0)[1:-1]
    assert abs(int(np.argmax(mel.mean(axis=1))) - int(np.argmin(np.abs(centers - f0)))) <= 1


def test_dnsmos_featurization_contract():
    feats = tgated._dnsmos_melspec(np.random.RandomState(12).randn(int(9.01 * 16000)).astype(np.float32)[:-160],
                                   16000)
    assert feats.shape == (900, 120) and feats.dtype == np.float32
    assert feats.max() == pytest.approx(1.0) and feats.min() >= -1.0 - 1e-6


def test_nisqa_featurization_contract():
    segments, n_wins = tgated._nisqa_features(np.random.RandomState(13).randn(2 * 48000).astype(np.float32), 48000)
    assert segments.shape == (1, 1300, 48, 15) and segments.dtype == np.float32
    assert n_wins == 187
    assert np.any(segments[0, n_wins - 1] != 0) and np.all(segments[0, n_wins:] == 0)
    with pytest.raises(RuntimeError, match="too short"):
        tgated._nisqa_features(np.zeros(480, dtype=np.float32), 48000)
