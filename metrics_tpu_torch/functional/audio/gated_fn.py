"""PESQ, DNSMOS and NISQA as functions (counterpart of ``metrics_tpu/functional/audio/gated_fn.py``).

PESQ wraps the ``pesq`` C library; DNSMOS and NISQA run the librosa-exact
featurization (``melspec.py``) through local onnx scorers. Each raises the JAX
package's ``ModuleNotFoundError`` when its package is missing, and nothing is
ever downloaded. The scores are float32 tensors on the inputs' device ("cuda"
for inputs that are not tensors, which raises without a CUDA device).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utils.imports import _ONNXRUNTIME_AVAILABLE, _PESQ_AVAILABLE

__all__ = [
    "perceptual_evaluation_speech_quality",
    "deep_noise_suppression_mean_opinion_score",
    "non_intrusive_speech_quality_assessment",
]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32) if isinstance(x, Tensor) else np.asarray(x, dtype=np.float32)


def _out(values, like) -> Tensor:
    device = like.device if isinstance(like, Tensor) else resolve_device(None)
    return torch.from_numpy(np.asarray(values, dtype=np.float32)).to(device)


def _pesq_one(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str) -> float:
    """One pair's PESQ (module level, so that a worker pool can pickle it)."""
    import pesq as pesq_backend

    return float(pesq_backend.pesq(fs, ref, deg, mode))


def perceptual_evaluation_speech_quality(
    preds,
    target,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    n_processes: int = 1,
) -> Tensor:
    """PESQ (MOS-LQO) of each waveform of (..., time) through the ``pesq`` C library."""
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that `pesq` is installed. Install as `pip install pesq`."
        )
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    p = _host(preds)
    t = _host(target)
    if p.shape != t.shape:
        raise ValueError(
            f"Expected `preds` and `target` to have the same shape, but got {p.shape} and {t.shape}"
        )
    batch_shape = p.shape[:-1]
    flat = list(zip(p.reshape(-1, p.shape[-1]), t.reshape(-1, t.shape[-1])))
    if n_processes > 1 and len(flat) > 1:
        import multiprocessing as mp

        with mp.Pool(processes=min(n_processes, len(flat))) as pool:
            vals = pool.starmap(_pesq_one, [(fs, ti, pi, mode) for pi, ti in flat])
    else:
        vals = [_pesq_one(fs, ti, pi, mode) for pi, ti in flat]
    return _out(np.asarray(vals).reshape(batch_shape), preds)


# scorers (and their two onnx sessions) kept across calls when cache_session=True
_DNSMOS_SCORERS: dict = {}


def deep_noise_suppression_mean_opinion_score(
    preds,
    fs: int,
    personalized: bool = False,
    device: Optional[str] = None,
    num_threads: Optional[int] = None,
    cache_session: bool = True,
) -> Tensor:
    """DNSMOS ``[p808_mos, mos_sig, mos_bak, mos_ovr]`` of each waveform of (..., time), (..., 4). ``device``
    names the onnx scorers' device, which must be the CPU."""
    if not _ONNXRUNTIME_AVAILABLE:
        raise ModuleNotFoundError(
            "DNSMOS metric requires that `onnxruntime` is installed."
            " Install as `pip install onnxruntime`."
        )
    if device is not None and "cpu" not in str(device).lower():
        raise ValueError(
            f"DNSMOS onnx scorers run host-side on CPU in this build; got device={device!r}."
        )
    from metrics_tpu_torch.audio.gated import DeepNoiseSuppressionMeanOpinionScore

    key = (fs, personalized, num_threads)
    scorer = _DNSMOS_SCORERS.get(key) if cache_session else None
    if scorer is None:
        scorer = DeepNoiseSuppressionMeanOpinionScore(
            fs=fs, personalized=personalized, num_threads=num_threads, device="cpu"
        )
        if cache_session:
            _DNSMOS_SCORERS[key] = scorer
    p = _host(preds)
    rows = [scorer._scores_for(wav) for wav in p.reshape(-1, p.shape[-1])]
    return _out(np.asarray(rows).reshape(*p.shape[:-1], 4), preds)


# metrics (holding their onnx session) kept across calls
_NISQA_SCORERS: dict = {}


def non_intrusive_speech_quality_assessment(preds, fs: int) -> Tensor:
    """NISQA ``[mos, noisiness, discontinuity, coloration, loudness]`` of each waveform of (..., time),
    (..., 5)."""
    if not _ONNXRUNTIME_AVAILABLE:
        raise ModuleNotFoundError(
            "NISQA metric requires that `onnxruntime` is installed."
            " Install as `pip install onnxruntime`."
        )
    from metrics_tpu_torch.audio.gated import NonIntrusiveSpeechQualityAssessment

    metric = _NISQA_SCORERS.get(fs)
    if metric is None:
        metric = _NISQA_SCORERS[fs] = NonIntrusiveSpeechQualityAssessment(fs=fs, device="cpu")
    p = _host(preds)
    rows = []
    for wav in p.reshape(-1, p.shape[-1]):
        metric.reset()
        metric.update(torch.from_numpy(wav))
        rows.append(metric.compute().numpy())
    return _out(np.asarray(rows).reshape(*p.shape[:-1], 5), preds)
