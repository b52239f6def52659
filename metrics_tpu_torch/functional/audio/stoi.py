"""STOI and ESTOI without ``pystoi`` (counterpart of ``metrics_tpu/functional/audio/stoi.py``).

* STOI: C. H. Taal, R. C. Hendriks, R. Heusdens, J. Jensen, "An Algorithm for
  Intelligibility Prediction of Time-Frequency Weighted Noisy Speech", IEEE
  TASLP 2011.
* ESTOI: J. Jensen, C. H. Taal, "An Algorithm for Predicting the
  Intelligibility of Speech Masked by Modulated Noise Maskers", IEEE TASLP 2016.

Resampling to 10 kHz and the removal of silent frames run on the host in
float64 numpy, as in the JAX package: the removal decides each signal's
length. The rest (framing, the 512-point FFT, the one-third-octave bands, the
384 ms segments and their correlations) runs on the device in ``acc_dtype()``,
for every waveform of a call at once: the frames of all waveforms are
concatenated, each segment gathers its 30 frames, and one index-add takes each
waveform's mean. The JAX package computes that stage in float32 under its
default regime (``jnp.asarray`` of the float64 host signals), so the port's
float32 agrees with it and float64 is the x64 regime's counterpart.

Constants (both papers): 10 kHz analysis rate; 256-sample Hann frames, 50 %
overlap, 512-point FFT; 15 one-third-octave bands from 150 Hz; N = 30-frame
segments; a 40 dB range for silent frames; clipping at -15 dB SDR (STOI only).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utils.compute import acc_dtype

__all__ = ["stoi_native", "short_time_objective_intelligibility"]

_FS = 10_000
_FRAME = 256
_HOP = 128
_NFFT = 512
_NUM_BANDS = 15
_MIN_FREQ = 150.0
_SEG = 30  # frames per analysis segment (384 ms)
_BETA = -15.0  # clipping bound, dB
_DYN_RANGE = 40.0  # silent-frame energy range, dB
_TOO_SHORT = 1e-5


def _hann(n: int) -> np.ndarray:
    # matlab's hanning(n): the symmetric Hann window without its zero end points
    return np.hanning(n + 2)[1:-1].astype(np.float64)


def _resample_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == _FS:
        return x.astype(np.float64)
    from metrics_tpu_torch.audio.gated import _resample  # raises its own error without scipy

    return _resample(x.astype(np.float64), int(fs), _FS)


def _frame(x: np.ndarray) -> np.ndarray:
    n = (len(x) - _FRAME) // _HOP + 1
    if n <= 0:
        return np.zeros((0, _FRAME))
    idx = np.arange(n)[:, None] * _HOP + np.arange(_FRAME)[None, :]
    return x[idx]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop the frames whose clean-signal energy lies more than 40 dB below the loudest frame's, then rebuild
    both signals by overlap-add (Taal et al. II-A); a Hann window at 50 % overlap sums to one."""
    w = _hann(_FRAME)
    xf = _frame(x) * w
    yf = _frame(y) * w
    if not len(xf):
        return x, y
    energy_db = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = energy_db > energy_db.max() - _DYN_RANGE
    xk, yk = xf[keep], yf[keep]
    out_len = (len(xk) - 1) * _HOP + _FRAME if len(xk) else 0
    x_sil = np.zeros(out_len)
    y_sil = np.zeros(out_len)
    for j, (xj, yj) in enumerate(zip(xk, yk)):
        x_sil[j * _HOP : j * _HOP + _FRAME] += xj
        y_sil[j * _HOP : j * _HOP + _FRAME] += yj
    return x_sil, y_sil


def _third_octave_matrix() -> np.ndarray:
    """(15, 257) 0/1 matrix pooling the rfft bins into one-third-octave bands."""
    freqs = np.arange(_NFFT // 2 + 1) * (_FS / _NFFT)
    cf = _MIN_FREQ * 2.0 ** (np.arange(_NUM_BANDS) / 3.0)
    lo = cf / 2.0 ** (1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    return ((freqs[None, :] >= lo[:, None]) & (freqs[None, :] < hi[:, None])).astype(np.float64)


def _host_signals(preds: np.ndarray, target: np.ndarray, fs: int) -> Tuple[np.ndarray, np.ndarray]:
    """One pair resampled to 10 kHz and freed of its silent frames, float64 on the host."""
    x = _resample_10k(target, fs)  # clean
    y = _resample_10k(preds, fs)  # degraded
    return _remove_silent_frames(x, y)


def _stoi_d(x_seg: Tensor, y_seg: Tensor) -> Tensor:
    """Classic STOI per segment: each (segment, band) row of y normalized to x's energy and clipped, then
    correlated with x; the mean over the bands, (S,)."""
    eps = 1e-12
    norm_x = torch.linalg.vector_norm(x_seg, dim=2, keepdim=True)
    norm_y = torch.linalg.vector_norm(y_seg, dim=2, keepdim=True)
    y_norm = y_seg * (norm_x / torch.clamp(norm_y, min=eps))
    clip_gain = 1.0 + 10.0 ** (-_BETA / 20.0)
    y_prime = torch.minimum(y_norm, x_seg * clip_gain)
    xc = x_seg - x_seg.mean(dim=2, keepdim=True)
    yc = y_prime - y_prime.mean(dim=2, keepdim=True)
    corr = (xc * yc).sum(2) / torch.clamp(
        torch.linalg.vector_norm(xc, dim=2) * torch.linalg.vector_norm(yc, dim=2), min=eps)
    return corr.mean(1)


def _estoi_d(x_seg: Tensor, y_seg: Tensor) -> Tensor:
    """ESTOI per segment: rows then columns normalized, the inner products averaged over the N frames, (S,)."""
    eps = 1e-12

    def _row_col(z: Tensor) -> Tensor:
        z = z - z.mean(dim=2, keepdim=True)
        z = z / torch.clamp(torch.linalg.vector_norm(z, dim=2, keepdim=True), min=eps)
        z = z - z.mean(dim=1, keepdim=True)
        return z / torch.clamp(torch.linalg.vector_norm(z, dim=1, keepdim=True), min=eps)

    return (_row_col(x_seg) * _row_col(y_seg)).sum(dim=(1, 2)) / _SEG


def _device_stage(signals: List[Tuple[np.ndarray, np.ndarray]], extended: bool, device: torch.device) -> Tensor:
    """Mean segment score of each (clean, degraded) pair, all pairs at once on ``device`` in ``acc_dtype()``;
    every pair must have at least 30 frames."""
    dtype = acc_dtype()
    frames_per = [(len(x) - _FRAME) // _HOP + 1 for x, _ in signals]
    segs_per = [m - _SEG + 1 for m in frames_per]
    frame_starts = np.cumsum([0] + frames_per[:-1])
    # each segment's 30 frames, as rows of the concatenated frames; and its pair
    seg_frame = np.concatenate([s + np.arange(k)[:, None] + np.arange(_SEG)[None, :]
                                for s, k in zip(frame_starts, segs_per)])
    seg_pair = np.repeat(np.arange(len(signals)), segs_per)
    sample_idx = np.concatenate([off + np.arange(m)[:, None] * _HOP + np.arange(_FRAME)[None, :]
                                 for off, m in zip(np.cumsum([0] + [len(x) for x, _ in signals[:-1]]), frames_per)])
    host = np.stack([np.concatenate([x for x, _ in signals]), np.concatenate([y for _, y in signals])])
    both = torch.from_numpy(host).to(device=device, dtype=dtype)  # (2, total samples)
    window = torch.from_numpy(_hann(_FRAME)).to(device=device, dtype=dtype)
    frames = both[:, torch.from_numpy(sample_idx).to(device)] * window  # (2, M, 256)
    power = torch.fft.rfft(frames, n=_NFFT, dim=-1).abs() ** 2  # (2, M, 257)
    obm = torch.from_numpy(_third_octave_matrix()).to(device=device, dtype=dtype)
    bands = torch.sqrt(power @ obm.T)  # (2, M, 15)
    seg = bands[:, torch.from_numpy(seg_frame).to(device)].transpose(-1, -2)  # (2, S, 15, 30)
    d = _estoi_d(seg[0], seg[1]) if extended else _stoi_d(seg[0], seg[1])  # (S,)
    pair = torch.from_numpy(seg_pair).to(device)
    sums = torch.zeros(len(signals), dtype=dtype, device=device).index_add_(0, pair, d)
    return sums / torch.tensor(segs_per, dtype=dtype, device=device)


def _as_host(x) -> np.ndarray:
    if isinstance(x, Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _scores(p2: np.ndarray, t2: np.ndarray, fs: int, extended: bool, device: torch.device) -> Tensor:
    """Float32 score of each row pair of (n, time) host arrays, on ``device``."""
    signals = [_host_signals(pi, ti, fs) for pi, ti in zip(p2, t2)]
    long_enough = [len(x) >= _FRAME and (len(x) - _FRAME) // _HOP + 1 >= _SEG for x, _ in signals]
    out = torch.full((len(signals),), _TOO_SHORT, dtype=torch.float32, device=device)
    if not all(long_enough):
        warnings.warn(
            "Not enough active speech frames for a full 384 ms STOI segment; returning 1e-5.",
            RuntimeWarning,
            stacklevel=3,
        )
    keep = [i for i, ok in enumerate(long_enough) if ok]
    if keep:
        values = _device_stage([signals[i] for i in keep], extended, device).to(torch.float32)
        out[torch.tensor(keep, device=device)] = values
    return out


def stoi_native(preds, target, fs: int, extended: bool = False, *,
                device: Optional[Union[str, torch.device]] = None) -> float:
    """STOI (or ESTOI) of one degraded and clean pair of 1-D waveforms; its device stage on ``device``
    ("cuda" when omitted).

    >>> rng = np.random.RandomState(7)
    >>> clean = rng.randn(16000)
    >>> round(stoi_native(clean, clean, 16000, device="cpu"), 3)
    1.0
    """
    p = _as_host(preds).reshape(-1)
    t = _as_host(target).reshape(-1)
    if p.shape != t.shape:
        raise ValueError(
            f"Expected `preds` and `target` to have the same shape, but got {p.shape} and {t.shape}"
        )
    dev = resolve_device(device)
    x, y = _host_signals(p, t, fs)
    num_frames = (len(x) - _FRAME) // _HOP + 1 if len(x) >= _FRAME else 0
    if num_frames < _SEG:
        warnings.warn(
            "Not enough active speech frames for a full 384 ms STOI segment; returning 1e-5.",
            RuntimeWarning,
            stacklevel=2,
        )
        return _TOO_SHORT
    return float(_device_stage([(x, y)], extended, dev)[0])


def short_time_objective_intelligibility(
    preds, target, fs: int, extended: bool = False, keep_same_device: bool = False, *,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """STOI of waveforms (..., time): one float32 score each, on the inputs' device (``device`` for inputs
    that are not tensors; "cuda" when omitted). ``pystoi`` is used when installed, as in the JAX package;
    otherwise the native pipeline above.

    >>> rng = np.random.RandomState(0)
    >>> clean = torch.from_numpy(rng.randn(2, 16000))
    >>> [round(v, 3) for v in short_time_objective_intelligibility(clean, clean, fs=16000).tolist()]
    [1.0, 1.0]
    """
    from metrics_tpu_torch.utils.imports import _PYSTOI_AVAILABLE

    dev = preds.device if isinstance(preds, Tensor) else resolve_device(device)
    p = _as_host(preds)
    t = _as_host(target)
    if p.shape != t.shape:
        raise ValueError(
            f"Expected `preds` and `target` to have the same shape, but got {p.shape} and {t.shape}"
        )
    batch_shape = p.shape[:-1]
    p2 = p.reshape(-1, p.shape[-1])
    t2 = t.reshape(-1, t.shape[-1])
    if _PYSTOI_AVAILABLE:
        from pystoi import stoi as stoi_backend

        vals = [float(stoi_backend(ti, pi, fs, extended=extended)) for pi, ti in zip(p2, t2)]
        return torch.from_numpy(np.asarray(vals, dtype=np.float32).reshape(batch_shape)).to(dev)
    return _scores(p2, t2, fs, extended, dev).reshape(batch_shape)
