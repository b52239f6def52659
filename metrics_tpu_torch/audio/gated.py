"""Audio metrics on host libraries or on their own host stages: PESQ, STOI, SRMR, DNSMOS, NISQA (counterpart
of ``metrics_tpu/audio/gated.py``).

PESQ needs the ``pesq`` C library, and DNSMOS and NISQA need ``onnxruntime``
with the pretrained scorer files in the directory ``METRICS_TPU_WEIGHTS``
names: without them, construction raises the JAX package's
``ModuleNotFoundError``, and nothing is downloaded. STOI and SRMR need no
optional package (``pystoi`` is used for STOI when installed) and never gate:
their device stages run on the metric's device.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.compute import count_dtype
from metrics_tpu_torch.utils.imports import _ONNXRUNTIME_AVAILABLE, _PESQ_AVAILABLE


def _host_rows(x) -> np.ndarray:
    """(..., time) waveforms as float32 host rows."""
    arr = x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)
    return arr.astype(np.float32).reshape(-1, arr.shape[-1])


class _HostAudioMetric(Metric):
    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_value", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    def _add(self, scores: Tensor) -> None:
        scores = torch.atleast_1d(scores)
        self.sum_value = self.sum_value + scores.sum()
        self.total = self.total + scores.numel()

    def compute(self) -> Tensor:
        """Compute metric."""
        return (self.sum_value / self.total).to(torch.float32)


class PerceptualEvaluationSpeechQuality(_HostAudioMetric):
    """PESQ through the ``pesq`` C library."""

    def __init__(self, fs: int, mode: str, **kwargs: Any) -> None:
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that `pesq` is installed."
                " Install as `pip install pesq`."
            )
        super().__init__(**kwargs)
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.fs = fs
        self.mode = mode

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with degraded and reference speech."""
        import pesq as pesq_backend

        vals = [pesq_backend.pesq(self.fs, ti, pi, self.mode) for pi, ti in zip(_host_rows(preds), _host_rows(target))]
        self._add(torch.tensor(vals, dtype=torch.float32, device=self.device))


class ShortTimeObjectiveIntelligibility(_HostAudioMetric):
    """STOI (or ESTOI with ``extended``): ``pystoi`` when installed, else the native pipeline of
    :mod:`metrics_tpu_torch.functional.audio.stoi`, whose device stage runs on the metric's device. Never
    gated.

    >>> rng = np.random.RandomState(0)
    >>> clean = torch.from_numpy(rng.randn(16000))
    >>> m = ShortTimeObjectiveIntelligibility(fs=16000, device="cpu")
    >>> m.update(clean, clean)
    >>> round(float(m.compute()), 3)
    1.0
    """

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.fs = fs
        self.extended = extended

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Update state with degraded and reference speech."""
        from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility

        self._add(short_time_objective_intelligibility(preds, target, self.fs, extended=self.extended,
                                                        device=self.device).to(self.device))


class SpeechReverberationModulationEnergyRatio(_HostAudioMetric):
    """SRMR through the port's gammatone and modulation filterbanks
    (:mod:`metrics_tpu_torch.functional.audio.srmr`); needs no optional package.

    >>> rng = np.random.RandomState(0)
    >>> t = np.arange(8000) / 8000.0
    >>> m = SpeechReverberationModulationEnergyRatio(fs=8000, device="cpu")
    >>> m.update(torch.from_numpy((1 + np.sin(2 * np.pi * 8 * t)) * rng.randn(8000)))
    >>> bool(m.compute() > 1.0)
    True
    """

    def __init__(
        self,
        fs: int,
        n_cochlear_filters: int = 23,
        low_freq: float = 125,
        min_cf: float = 4,
        max_cf: Any = None,
        norm: bool = False,
        fast: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if fs <= 0:
            raise ValueError(f"Expected argument `fs` to be a positive integer, but got {fs}")
        self.fs = fs
        self.n_cochlear_filters = n_cochlear_filters
        self.low_freq = low_freq
        self.min_cf = min_cf
        self.max_cf = max_cf
        self.norm = norm
        self.fast = fast

    def update(self, preds: Tensor) -> None:
        """Update with waveform(s) ``(..., time)``."""
        from metrics_tpu_torch.functional.audio.srmr import speech_reverberation_modulation_energy_ratio

        self._add(speech_reverberation_modulation_energy_ratio(
            preds, self.fs, self.n_cochlear_filters, self.low_freq, self.min_cf, self.max_cf, self.norm,
            self.fast, device=self.device,
        ))


def _local_model_path(filename: str, what: str) -> str:
    """The path of a pretrained scorer file in the directory ``METRICS_TPU_WEIGHTS`` names (nothing is fetched)."""
    import os

    weights_dir = os.environ.get("METRICS_TPU_WEIGHTS")
    path = os.path.join(weights_dir, filename) if weights_dir else None
    if not path or not os.path.exists(path):
        raise ModuleNotFoundError(
            f"{what} needs the pretrained model file {filename!r} in the directory given by"
            " METRICS_TPU_WEIGHTS. This offline build never downloads."
        )
    return path


def _dnsmos_melspec(audio: np.ndarray, sr: int) -> np.ndarray:
    """DNSMOS P.808 input featurization, shape ``(n_frames, 120)``.

    Librosa-exact copy of TorchMetrics' ``_audio_melspec``
    (``functional/audio/dnsmos.py:121-153``): ``melspectrogram(n_fft=321,
    hop=160, n_mels=120, power=2)`` with a centered zero-padded STFT (the
    librosa ≥0.10 default, which TorchMetrics' ``librosa <0.11`` pin hits)
    and the Slaney filterbank, then ``(power_to_db(ref=max) + 40) / 40``. For
    the standard 9.01 s hop trimmed by 160 samples this yields the ``(900,
    120)`` frame grid ``model_v8.onnx`` was exported for.
    """
    from metrics_tpu_torch.functional.audio.melspec import melspectrogram, power_to_db

    mel = melspectrogram(
        audio, sr, n_fft=321, hop_length=160, n_mels=120, power=2.0, pad_mode="constant"
    ).T  # (T', 120)
    db = power_to_db(mel, ref=float(mel.max()))
    return ((db + 40.0) / 40.0).astype(np.float32)


# Published NISQA v2.0 featurization constants (TorchMetrics reads the same
# values out of its downloaded checkpoint's ``args`` dict, ``nisqa.py:135``).
_NISQA_ARGS = {
    "ms_n_fft": 4096,
    "ms_hop_length": 0.01,  # seconds
    "ms_win_length": 0.02,  # seconds
    "ms_n_mels": 48,
    "ms_fmax": 20000.0,
    "ms_seg_length": 15,
    "ms_seg_hop_length": 1,
    "ms_max_segments": 1300,
}


def _nisqa_features(audio: np.ndarray, sr: int, args: dict = _NISQA_ARGS) -> tuple:
    """NISQA input featurization: segmented mel windows + window count.

    Librosa-exact copy of TorchMetrics' ``_get_librosa_melspec`` + ``_segment_specs``
    (``functional/audio/nisqa.py:322-391``): magnitude (power=1) melspectrogram at
    ``n_fft=4096``, 10 ms hop / 20 ms window, 48 Slaney mels to 20 kHz,
    ``amplitude_to_db(ref=1, amin=1e-4, top_db=80)``; then every ``seg_length=15``-frame
    window at ``seg_hop`` stride, zero-padded to ``max_segments=1300``.

    Returns ``(segments, n_wins)`` with ``segments`` of shape
    ``(1, max_segments, n_mels, seg_length)`` float32 and ``n_wins`` the number of
    valid windows — the two inputs the onnx export of the published NISQA model
    takes (outputs: ``(1, 5)`` = [mos, noi, dis, col, loud]).
    """
    from metrics_tpu_torch.functional.audio.melspec import amplitude_to_db, melspectrogram

    hop = int(sr * args["ms_hop_length"])
    win = int(sr * args["ms_win_length"])
    mel = melspectrogram(
        audio, sr, n_fft=args["ms_n_fft"], hop_length=hop, win_length=win,
        n_mels=args["ms_n_mels"], fmax=args["ms_fmax"], power=1.0,
        pad_mode="reflect",  # NISQA passes pad_mode explicitly (``nisqa.py:349``)
    )
    spec = amplitude_to_db(mel, ref=1.0, amin=1e-4, top_db=80.0).astype(np.float32)  # (n_mels, T)
    seg_length = args["ms_seg_length"]
    seg_hop = args["ms_seg_hop_length"]
    max_length = args["ms_max_segments"]
    n_wins = spec.shape[1] - (seg_length - 1)
    if n_wins < 1:
        raise RuntimeError("Input signal is too short.")
    idx = np.arange(seg_length)[None, :] + np.arange(n_wins)[:, None]
    segments = spec.T[idx].transpose(0, 2, 1)[::seg_hop]  # (n_wins', n_mels, seg_length)
    n_wins = -(-n_wins // seg_hop)
    if max_length < n_wins:
        raise RuntimeError("Maximum number of mel spectrogram windows exceeded. Use shorter audio.")
    padded = np.zeros((1, max_length, spec.shape[0], seg_length), dtype=np.float32)
    padded[0, :n_wins] = segments
    return padded, n_wins


def _resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return audio
    from math import gcd

    try:
        from scipy.signal import resample_poly
    except ImportError as err:
        raise ModuleNotFoundError(
            f"Resampling {sr_in} Hz input to the model's native {sr_out} Hz requires `scipy`."
            " Install it, or provide audio at the native rate."
        ) from err
    g = gcd(sr_in, sr_out)
    # dtype-preserving: DNSMOS/NISQA feed float32, the native STOI feeds float64
    return resample_poly(audio, sr_out // g, sr_in // g).astype(audio.dtype)


class DeepNoiseSuppressionMeanOpinionScore(Metric):
    """DNSMOS through pretrained onnxruntime scorers on the host CPU.

    The published method: resample to 16 kHz, tile to at least 9.01 s, hop in
    1 s steps; at each hop ``model_v8.onnx`` (P.808, on log-power mel features)
    and ``[p]sig_bak_ovr.onnx`` (P.835, on the raw audio), then the published
    polynomial calibrations, averaged over the hops. The model files come from
    the directory ``METRICS_TPU_WEIGHTS`` names. ``compute`` returns the
    4-vector ``[p808_mos, mos_sig, mos_bak, mos_ovr]``.
    """

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _INPUT_LEN_S = 9.01
    _FS = 16000

    def __init__(
        self, fs: int, personalized: bool = False, num_threads: Optional[int] = None, **kwargs: Any
    ) -> None:
        if not _ONNXRUNTIME_AVAILABLE:
            raise ModuleNotFoundError(
                "DeepNoiseSuppressionMeanOpinionScore metric requires that `onnxruntime` is installed."
                " Install as `pip install onnxruntime`."
            )
        super().__init__(**kwargs)
        self.fs = fs
        self.personalized = personalized
        self.num_threads = num_threads
        self._sessions = None
        self.add_state("sum_dnsmos", torch.zeros(4), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    # published DNSMOS P.835/P.808 calibration polynomials (highest degree first)
    _POLY_PERSONALIZED = {
        "sig": (-0.01019296, 0.02751166, 1.19576786, -0.24348726),
        "bak": (-0.04976499, 0.44276479, -0.1644611, 0.96883132),
        "ovr": (-0.00533021, 0.005101, 1.18058466, -0.11236046),
    }
    _POLY_DEFAULT = {
        "sig": (-0.08397278, 1.22083953, 0.0052439),
        "bak": (-0.13166888, 1.60915514, -0.39604546),
        "ovr": (-0.06766283, 1.11546468, 0.04602535),
    }

    def _scores_for(self, audio: np.ndarray) -> np.ndarray:
        import onnxruntime as ort

        if self._sessions is None:
            opts = ort.SessionOptions()
            if self.num_threads is not None:
                opts.inter_op_num_threads = self.num_threads
                opts.intra_op_num_threads = self.num_threads
            name = ("p" if self.personalized else "") + "sig_bak_ovr.onnx"
            self._sessions = (
                ort.InferenceSession(_local_model_path(name, "DNSMOS"), opts, providers=["CPUExecutionProvider"]),
                ort.InferenceSession(_local_model_path("model_v8.onnx", "DNSMOS (P.808)"), opts, providers=["CPUExecutionProvider"]),
            )
        sess_835, sess_808 = self._sessions
        if audio.shape[-1] == 0:
            raise ValueError("DNSMOS received an empty waveform")
        audio = _resample(audio, self.fs, self._FS)
        need = int(self._INPUT_LEN_S * self._FS)
        while audio.shape[-1] < need:
            audio = np.concatenate([audio, audio], axis=-1)
        num_hops = int(np.floor(audio.shape[-1] / self._FS) - self._INPUT_LEN_S) + 1
        polys = self._POLY_PERSONALIZED if self.personalized else self._POLY_DEFAULT
        hop_scores = []
        for idx in range(max(num_hops, 1)):
            seg = audio[int(idx * self._FS) : int((idx + self._INPUT_LEN_S) * self._FS)].astype(np.float32)
            mel = _dnsmos_melspec(seg[:-160], self._FS)[None].astype(np.float32)
            p808 = float(sess_808.run(None, {sess_808.get_inputs()[0].name: mel})[0].reshape(-1)[0])
            raw = sess_835.run(None, {sess_835.get_inputs()[0].name: seg[None]})[0].reshape(-1)
            sig, bak, ovr = (float(np.polyval(polys[k], v)) for k, v in zip(("sig", "bak", "ovr"), raw[:3]))
            hop_scores.append([p808, sig, bak, ovr])
        return np.mean(np.asarray(hop_scores), axis=0)

    def update(self, preds: Tensor) -> None:
        """Update with waveform(s) ``(..., time)``."""
        rows = [self._scores_for(wav) for wav in _host_rows(preds)]
        self.sum_dnsmos = self.sum_dnsmos + torch.from_numpy(np.asarray(rows, dtype=np.float32)).to(self.device).sum(0)
        self.total = self.total + len(rows)

    def compute(self) -> Tensor:
        """Average ``[p808_mos, mos_sig, mos_bak, mos_ovr]`` over all waveforms."""
        return (self.sum_dnsmos / torch.clamp(self.total, min=1)).to(torch.float32)


class NonIntrusiveSpeechQualityAssessment(Metric):
    """NISQA through an onnx export of the published model, on the host CPU.

    48 kHz mel segments go through a local ``nisqa.onnx`` session to the 5 MOS
    dimensions ``[mos, noisiness, discontinuity, coloration, loudness]``, all
    accumulated; ``compute`` returns the averaged 5-vector. The model file
    comes from the directory ``METRICS_TPU_WEIGHTS`` names.
    """

    __jit_ineligible__ = True
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, fs: int, **kwargs: Any) -> None:
        if not _ONNXRUNTIME_AVAILABLE:
            raise ModuleNotFoundError(
                "NonIntrusiveSpeechQualityAssessment metric requires that `onnxruntime` is installed."
                " Install as `pip install onnxruntime`."
            )
        super().__init__(**kwargs)
        if fs <= 0:
            raise ValueError(f"Expected argument `fs` to be a positive integer, but got {fs}")
        self.fs = fs
        self._session = None
        self.add_state("sum_nisqa", torch.zeros(5), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=count_dtype()), dist_reduce_fx="sum")

    _FS = 48000  # the published model's native rate; 20 ms / 10 ms framing below

    def update(self, preds: Tensor) -> None:
        """Update with waveform(s) ``(..., time)``; input is resampled to 48 kHz."""
        import onnxruntime as ort

        if self._session is None:
            self._session = ort.InferenceSession(
                _local_model_path("nisqa.onnx", "NISQA"), providers=["CPUExecutionProvider"]
            )
        inputs = self._session.get_inputs()
        has_n_wins_input = len(inputs) > 1  # exports carrying the explicit window-count input
        for wav in _host_rows(preds):
            wav48 = _resample(wav, self.fs, self._FS)
            segments, n_wins = _nisqa_features(wav48, self._FS)
            feed = {inputs[0].name: segments}
            if has_n_wins_input:
                feed[inputs[1].name] = np.asarray([n_wins], dtype=np.int64)
            out = self._session.run(None, feed)[0].reshape(-1)
            self.sum_nisqa = self.sum_nisqa + torch.from_numpy(np.asarray(out[:5], dtype=np.float32)).to(self.device)
            self.total = self.total + 1

    def compute(self) -> Tensor:
        """Average ``[mos, noi, dis, col, loud]`` over all waveforms."""
        return (self.sum_nisqa / torch.clamp(self.total, min=1)).to(torch.float32)
