"""Speech-to-reverberation modulation energy ratio (counterpart of ``metrics_tpu/functional/audio/srmr.py``).

The JAX package's frequency-domain formulation of SRMR (Falk et al., 2010),
batched over waveforms on the device in float32:

1. a 4th-order gammatone filterbank, ``n_cochlear_filters`` ERB-spaced
   centre frequencies from ``low_freq`` to 0.9 of ``fs/2``, applied as FFT
   products of impulse responses 128 ms long;
2. each band's temporal envelope, the magnitude of its analytic signal;
3. 8 modulation bands (second-order resonator magnitudes, Q = 2, centre
   frequencies log-spaced ``min_cf``..``max_cf``) applied to the envelope spectra;
4. the energies of 256 ms frames every 64 ms (with ``norm``, clipped 30 dB
   below the waveform's peak frame energy);
5. the energy of the 4 low modulation bands over that of the 4 high ones.

The frames' energies are sums over strided views of the squared modulation
signals, so no copy of the overlapping frames is made; waveforms go through
in chunks of at most ``_CHUNK_BYTES`` of modulation signal.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device

__all__ = ["speech_reverberation_modulation_energy_ratio"]

_EAR_Q = 9.26449
_MIN_BW = 24.7
_N_MOD = 8
_CHUNK_BYTES = 1 << 30


def _erb_center_freqs(low_freq: float, high_freq: float, n: int, device) -> Tensor:
    """ERB-rate-spaced centre frequencies (Glasberg and Moore), descending from ``high_freq``; float32."""
    c = _EAR_Q * _MIN_BW
    # the float32 step -log(high + c) + log(low + c) on the host, so that nothing is copied to the device
    ends = torch.log(torch.tensor([high_freq + c, low_freq + c], dtype=torch.float32))
    step = float(-ends[0] + ends[1])
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return -c + torch.exp(idx * step / n) * (high_freq + c)


def _gammatone_fir(fs: float, cfs: Tensor, n_taps: int) -> Tensor:
    """(bands, n_taps) 4th-order gammatone impulse responses, each scaled to a peak gain of 1."""
    t = torch.arange(n_taps, dtype=torch.float32, device=cfs.device) / fs
    erb = (cfs / _EAR_Q) + _MIN_BW
    b = 1.019 * erb
    ir = t**3 * torch.exp(-2 * math.pi * b[:, None] * t[None, :]) * torch.cos(2 * math.pi * cfs[:, None] * t[None, :])
    gain = torch.fft.rfft(ir, dim=-1).abs().amax(dim=-1, keepdim=True)
    return ir / torch.clamp(gain, min=1e-20)


def _analytic_envelope(x: Tensor) -> Tensor:
    """|analytic signal| along the last dimension (the FFT Hilbert transform)."""
    n = x.shape[-1]
    spec = torch.fft.fft(x, dim=-1)
    # 1 at DC (and at Nyquist for even n), 2 on the positive frequencies, 0 on the negative ones
    k = torch.arange(n, device=x.device)
    ones = (k == 0) | ((k == n // 2) if n % 2 == 0 else torch.zeros_like(k, dtype=torch.bool))
    h = torch.where(ones, 1.0, torch.where(k < (n + 1) // 2, 2.0, 0.0))
    return torch.fft.ifft(spec * h, dim=-1).abs()


def _srmr_chunk(x: Tensor, fs: int, fir: Tensor, resp: Tensor, win: int, hop: int, norm: bool) -> Tensor:
    """SRMR of each waveform of ``x`` (k, n)."""
    n = x.shape[-1]
    fir_len = fir.shape[-1]
    pad = n + fir_len
    spec_x = torch.fft.rfft(x, pad)
    spec_f = torch.fft.rfft(fir, pad, dim=-1)
    bands = torch.fft.irfft(spec_x[:, None, :] * spec_f[None], pad, dim=-1)[..., :n]  # (k, B, T)
    env = _analytic_envelope(bands)
    env_spec = torch.fft.rfft(env, dim=-1)  # (k, B, F)
    mod_sig = torch.fft.irfft(env_spec[:, :, None, :] * resp[None, None], n, dim=-1)  # (k, B, M, T)
    energy = mod_sig.square_().unfold(-1, min(win, n), hop).sum(-1)  # (k, B, M, frames)
    if norm:
        peak = energy.amax(dim=(1, 2, 3), keepdim=True)
        floor = peak / (10 ** (30.0 / 10.0))  # a 30 dB dynamic range
        energy = torch.maximum(energy, floor)
    total = energy.sum(dim=(1, 3))  # (k, M)
    return total[:, :4].sum(-1) / torch.clamp(total[:, 4:].sum(-1), min=1e-20)


def speech_reverberation_modulation_energy_ratio(
    preds,
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = None,
    norm: bool = False,
    fast: bool = False,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """SRMR of waveforms (..., time): one float32 score each, on the inputs' device (``device`` for inputs
    that are not tensors; "cuda" when omitted). ``max_cf`` defaults to 128 Hz, 30 Hz with ``norm``.

    >>> rng = np.random.RandomState(0)
    >>> t = np.arange(8000) / 8000.0
    >>> am = (1 + np.sin(2 * np.pi * 8 * t)) * rng.randn(8000)  # 8 Hz modulated noise
    >>> float(speech_reverberation_modulation_energy_ratio(torch.from_numpy(am), 8000)) > 1.0
    True
    """
    if fast:
        raise NotImplementedError(
            "`fast=True` selects the toolbox's gammatonegram pipeline, which produces materially"
            " different numbers; it is not implemented here — use the default fast=False path."
        )
    if max_cf is None:
        max_cf = 30.0 if norm else 128.0
    if not isinstance(preds, Tensor):
        preds = torch.from_numpy(np.asarray(preds)).to(resolve_device(device))
    fs = int(fs)
    flat = preds.reshape(-1, preds.shape[-1]).to(torch.float32)
    n = flat.shape[-1]
    dev = flat.device
    fir = _gammatone_fir(fs, _erb_center_freqs(float(low_freq), fs / 2 * 0.9, n_cochlear_filters, dev),
                         min(n, int(0.128 * fs)))
    ratio = (float(max_cf) / float(min_cf)) ** (1.0 / (_N_MOD - 1))
    mod_cfs = float(min_cf) * ratio ** torch.arange(_N_MOD, device=dev)  # float32
    freqs = torch.fft.rfftfreq(n, 1.0 / fs, device=dev)
    f_safe = torch.clamp(freqs[None, :], min=1e-6)
    q = 2.0
    resp = 1.0 / torch.sqrt(1.0 + q**2 * (f_safe / mod_cfs[:, None] - mod_cfs[:, None] / f_safe) ** 2)  # (M, F)
    win = max(int(0.256 * fs), 1)
    hop = max(int(0.064 * fs), 1)
    per_wave = n_cochlear_filters * _N_MOD * n * 4
    chunk = max(1, _CHUNK_BYTES // per_wave)
    scores = torch.cat([_srmr_chunk(flat[i:i + chunk], fs, fir, resp, win, hop, norm)
                        for i in range(0, flat.shape[0], chunk)])
    return scores.reshape(preds.shape[:-1]) if preds.ndim > 1 else scores[0]
