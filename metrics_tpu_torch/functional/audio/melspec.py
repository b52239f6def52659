"""librosa-exact mel spectrograms for the DNSMOS and NISQA featurization (counterpart of
``metrics_tpu/functional/audio/melspec.py``), in numpy on the host by design: the scorers are onnx sessions on
the CPU.

The pretrained scorers were calibrated on ``librosa.feature.melspectrogram``
with ``power_to_db``/``amplitude_to_db``, and librosa is not a dependency, so
its conventions are reproduced:

- STFT: ``center=True`` padding by ``n_fft // 2`` on both sides, mode
  ``"constant"`` (DNSMOS, librosa's default from 0.10) or ``"reflect"``
  (NISQA); a periodic Hann window of ``win_length`` zero-padded
  symmetrically to ``n_fft``; hop ``hop_length``; ``|rfft|**power``.
- Mel filterbank: the Slaney scale (linear below 1 kHz at ``f / (200/3)``,
  then ``log(6.4)/27`` per mel), triangles from float frequency ramps (not
  integer bin edges), area-normalized by ``2 / (f[m+2] - f[m])``.
- dB: ``power_to_db(ref, amin=1e-10, top_db=80)`` and
  ``amplitude_to_db(ref, amin, top_db)``, the ``top_db`` clamp taken against
  the maximum of the whole given array: batched callers loop per item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "hann_periodic",
    "mel_filterbank",
    "mel_frequencies",
    "melspectrogram",
    "power_to_db",
    "amplitude_to_db",
    "stft_power",
]

# Slaney mel-scale constants (librosa.core.convert.hz_to_mel defaults)
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    freq = np.asanyarray(freq, dtype=np.float64)
    mel = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mel = np.where(log_region, _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP, mel)
    return mel


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    mel = np.asanyarray(mel, dtype=np.float64)
    freq = _F_SP * mel
    log_region = mel >= _MIN_LOG_MEL
    return np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)), freq)


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """``n_mels`` frequencies evenly spaced on the Slaney mel scale (librosa ``mel_frequencies``)."""
    return _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels))


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filterbank, shape ``(n_mels, 1 + n_fft//2)``.

    Exactly librosa ``filters.mel(htk=False, norm="slaney")``: triangle weights are
    computed from continuous frequency ramps against the rfft bin frequencies.
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.fft.rfftfreq(n=n_fft, d=1.0 / sr)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    return weights * enorm[:, None]


def hann_periodic(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window of ``win_length``, zero-padded symmetrically to ``n_fft``.

    librosa's window pipeline: ``scipy.signal.get_window("hann", win_length,
    fftbins=True)`` then ``util.pad_center(..., size=n_fft)``.
    """
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    return w


def stft_power(
    y: np.ndarray, n_fft: int, hop_length: int, win_length: Optional[int] = None,
    power: float = 2.0, center: bool = True, pad_mode: str = "constant",
) -> np.ndarray:
    """``|STFT|**power`` with librosa conventions, shape ``(..., 1 + n_fft//2, n_frames)``."""
    y = np.asarray(y, dtype=np.float64)
    win_length = n_fft if win_length is None else win_length
    window = hann_periodic(win_length, n_fft)
    if center:
        pad = [(0, 0)] * (y.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        y = np.pad(y, pad, mode=pad_mode)
    if y.shape[-1] < n_fft:
        pad = [(0, 0)] * (y.ndim - 1) + [(0, n_fft - y.shape[-1])]
        y = np.pad(y, pad)
    n_frames = 1 + (y.shape[-1] - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = y[..., idx] * window  # (..., n_frames, n_fft)
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** power
    return np.moveaxis(spec, -1, -2)  # (..., n_freq, n_frames)


def melspectrogram(
    y: np.ndarray, sr: int, n_fft: int, hop_length: int, win_length: Optional[int] = None,
    n_mels: int = 128, fmin: float = 0.0, fmax: Optional[float] = None,
    power: float = 2.0, center: bool = True, pad_mode: str = "constant",
) -> np.ndarray:
    """librosa ``feature.melspectrogram`` (htk=False, norm="slaney"), shape ``(..., n_mels, n_frames)``."""
    spec = stft_power(y, n_fft, hop_length, win_length, power=power, center=center, pad_mode=pad_mode)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    return np.einsum("mf,...ft->...mt", fb, spec)


def power_to_db(s: np.ndarray, ref: float, amin: float = 1e-10, top_db: Optional[float] = 80.0) -> np.ndarray:
    """librosa ``power_to_db``: ``10*log10(max(s, amin)) - 10*log10(max(ref, amin))`` with top_db clamp."""
    log_spec = 10.0 * np.log10(np.maximum(s, amin)) - 10.0 * np.log10(np.maximum(ref, amin))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def amplitude_to_db(s: np.ndarray, ref: float = 1.0, amin: float = 1e-5, top_db: Optional[float] = 80.0) -> np.ndarray:
    """librosa ``amplitude_to_db`` = ``power_to_db(s**2, ref**2, amin**2)`` (i.e. ``20*log10``)."""
    return power_to_db(np.square(s), ref=ref**2, amin=amin**2, top_db=top_db)
