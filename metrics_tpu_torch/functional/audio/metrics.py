"""Signal-level audio metrics (counterpart of ``metrics_tpu/functional/audio/metrics.py``): SNR, SI-SDR,
SI-SNR, C-SI-SNR, SA-SDR, SDR, PIT and ``pit_permutate``, on the inputs' device.

SNR and its scale-invariant kin compute in float32 with float32's epsilon, as
the JAX package does. SDR finds the length-``filter_length`` filter that best
maps the target onto the prediction: the target's autocorrelation and the
cross-correlation come from one real FFT, and the batched Toeplitz systems are
solved by ``torch.linalg.solve_ex`` without its error check (the JAX package's
``jnp.linalg.solve`` never raises either), so an update reads nothing back on
the host. SDR computes in ``acc_dtype()`` and its diagonal loading is
``eps * max(acf[..., 0])`` over the whole batch, as in the JAX package: one
signal's value depends on its batch-mates. PIT scores every permutation on the
device below three speakers; from three it solves the assignment with scipy on
one host copy of the (batch, S, S) matrix.
"""

from __future__ import annotations

from itertools import permutations
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.compute import acc_dtype
from metrics_tpu_torch.utils.imports import _SCIPY_AVAILABLE
from metrics_tpu_torch.utils.prints import rank_zero_warn

_EPS32 = torch.finfo(torch.float32).eps


def _find_best_perm_by_linear_sum_assignment(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """Hungarian assignment over the (batch, pred_spk, target_spk) metric matrix, with scipy on one host copy.

    Returns ``(best_metric, best_perm)``, ``best_perm[b, j]`` the prediction assigned to target ``j`` (the
    ``pit_permutate`` convention), int32 on the matrix's device.
    """
    from scipy.optimize import linear_sum_assignment

    maximize = eval_func == "max"
    # rows = target, cols = pred, so the assignment's column index is a prediction per target
    mtx_tp = metric_mtx.transpose(-1, -2)
    host = mtx_tp.detach().cpu().numpy()
    if host.shape[0] == 0:
        perm = np.zeros((0, host.shape[1]), np.int32)
    else:
        perm = np.stack([linear_sum_assignment(row, maximize=maximize)[1] for row in host]).astype(np.int32)
    best_perm = torch.from_numpy(perm)
    if metric_mtx.device.type == "cuda":  # from pinned memory, so that the copy back does not wait for the card
        best_perm = best_perm.pin_memory().to(metric_mtx.device, non_blocking=True)
    best_metric = torch.gather(mtx_tp, 2, best_perm.long()[:, :, None])[..., 0].mean(-1)
    return best_metric, best_perm


_PERM_TABLES: dict = {}


def _perm_tables(spk: int, device: torch.device) -> Tuple[Tensor, Tensor]:
    """The permutations of ``spk`` sources in ``itertools`` order and their inverses, (S!, S) int64 on
    ``device``; made once per device, so that a later update copies nothing to the card."""
    key = (spk, device)
    if key not in _PERM_TABLES:
        perms = torch.tensor(list(permutations(range(spk))), dtype=torch.long)
        _PERM_TABLES[key] = (perms.to(device), torch.argsort(perms, dim=-1).to(device))
    return _PERM_TABLES[key]


def _zero_mean(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    return preds - preds.mean(-1, keepdim=True), target - target.mean(-1, keepdim=True)


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SNR in dB over the last dimension, in float32.

    >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
    >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
    >>> round(float(signal_noise_ratio(preds, target)), 4)
    16.1805
    """
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    if zero_mean:
        preds, target = _zero_mean(preds, target)
    noise = target - preds
    return 10 * torch.log10((torch.sum(target**2, dim=-1) + _EPS32) / (torch.sum(noise**2, dim=-1) + _EPS32))


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR in dB over the last dimension, in float32.

    >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
    >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
    >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 4)
    18.403
    """
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    if zero_mean:
        preds, target = _zero_mean(preds, target)
    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + _EPS32) / (
        torch.sum(target**2, dim=-1, keepdim=True) + _EPS32
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    return 10 * torch.log10((torch.sum(target_scaled**2, dim=-1) + _EPS32) / (torch.sum(noise**2, dim=-1) + _EPS32))


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR: SI-SDR of the zero-mean signals."""
    return scale_invariant_signal_distortion_ratio(preds, target, zero_mean=True)


def complex_scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """C-SI-SNR of complex spectra (..., F, T), or of real ones (..., F, T, 2): SI-SDR over the interleaved
    real and imaginary parts of all bins."""
    if not preds.is_complex():
        if preds.shape[-1] != 2:
            raise RuntimeError(
                "Expected `preds` and `target` to be complex tensors or real tensors with last dim 2,"
                f" but got {tuple(preds.shape)}"
            )
        p, t = preds, target
    else:
        p, t = torch.view_as_real(preds), torch.view_as_real(target)
    p = p.reshape(*p.shape[:-3], -1)
    t = t.reshape(*t.shape[:-3], -1)
    return scale_invariant_signal_distortion_ratio(p, t, zero_mean=zero_mean)


def source_aggregated_signal_distortion_ratio(
    preds: Tensor, target: Tensor, scale_invariant: bool = True, zero_mean: bool = False
) -> Tensor:
    """SA-SDR over (..., source, time): one ratio of the energies summed over the sources, with one scale
    shared by all sources when ``scale_invariant``."""
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    if zero_mean:
        preds, target = _zero_mean(preds, target)
    if scale_invariant:
        alpha = (torch.sum(preds * target, dim=(-2, -1), keepdim=True) + _EPS32) / (
            torch.sum(target**2, dim=(-2, -1), keepdim=True) + _EPS32
        )
        target = alpha * target
    distortion = target - preds
    num = torch.sum(target**2, dim=(-2, -1))
    den = torch.sum(distortion**2, dim=(-2, -1))
    return 10 * torch.log10((num + _EPS32) / (den + _EPS32))


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Any = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Any = None,
) -> Tensor:
    """BSS-eval SDR with the optimal distortion filter of ``filter_length`` taps, float32 in dB.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> target = torch.from_numpy(rng.randn(8000).astype(np.float32))
    >>> preds = target + 0.1 * torch.from_numpy(rng.randn(8000).astype(np.float32))
    >>> float(signal_distortion_ratio(preds, target)) > 15
    True
    """
    if use_cg_iter is not None:
        rank_zero_warn(
            "`use_cg_iter` is ignored: the Toeplitz system is solved densely on the MXU,"
            " which is faster than CG at filter_length=512.",
            UserWarning,
        )
    _check_same_shape(preds, target)
    dtype = acc_dtype()
    preds = preds.to(dtype)
    target = target.to(dtype)
    if zero_mean:
        preds, target = _zero_mean(preds, target)
    eps = torch.finfo(dtype).eps

    n = preds.shape[-1]
    lag = filter_length
    fft_len = 1
    while fft_len < n + lag:
        fft_len *= 2

    tf = torch.fft.rfft(target, fft_len, dim=-1)
    pf = torch.fft.rfft(preds, fft_len, dim=-1)
    acf = torch.fft.irfft(tf * torch.conj(tf), fft_len, dim=-1)[..., :lag]
    xcorr = torch.fft.irfft(torch.conj(tf) * pf, fft_len, dim=-1)[..., :lag]

    # the Toeplitz normal equations R w = b
    ar = torch.arange(lag, device=preds.device)
    r_mat = acf[..., (ar[:, None] - ar[None, :]).abs()]
    eye = torch.eye(lag, dtype=dtype, device=preds.device)
    if load_diag is not None:
        r_mat = r_mat + load_diag * eye
    else:
        r_mat = r_mat + eps * acf[..., :1].max() * eye
    sol = torch.linalg.solve_ex(r_mat, xcorr[..., None], check_errors=False)[0][..., 0]

    # the energy of the prediction's projection onto the span of the shifted targets
    num = torch.sum(sol * xcorr, dim=-1)
    den = torch.sum(preds**2, dim=-1) - num
    ratio = (num + eps) / (den + eps)
    return (10 * torch.log10(torch.clamp(ratio, min=eps))).to(torch.float32)


def permutation_invariant_training(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """The best mean metric over the permutations of the sources of (batch, spk, ...) inputs, and the best
    permutation (int32; ``best_perm[b, j]`` the prediction that matches target ``j``).

    Speaker-wise mode builds the (batch, spk, spk) metric matrix on the device and scores every permutation
    there below three speakers (the first best wins); from three it solves the assignment on the host with
    scipy, or enumerates the permutations without it. Permutation-wise mode calls ``metric_func`` on each
    whole permutation.

    >>> import numpy as np
    >>> rng = np.random.RandomState(42)
    >>> target = torch.from_numpy(rng.randn(2, 2, 100).astype(np.float32))
    >>> preds = target.flip(1)
    >>> best, perm = permutation_invariant_training(preds, target, scale_invariant_signal_distortion_ratio)
    >>> perm[0]
    tensor([1, 0], dtype=torch.int32)
    """
    if preds.ndim < 2:
        raise ValueError(f"Inputs must be of shape [batch, spk, ...], got {tuple(preds.shape)}")
    if eval_func not in ("max", "min"):
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ("speaker-wise", "permutation-wise"):
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    spk = preds.shape[1]
    device = preds.device
    perms = list(permutations(range(spk)))
    if mode == "speaker-wise":
        metric_mtx = torch.stack(
            [torch.stack([metric_func(preds[:, i], target[:, j], **kwargs) for j in range(spk)], dim=-1)
             for i in range(spk)],
            dim=-2,
        )  # (batch, pred, target)
        if spk >= 3 and _SCIPY_AVAILABLE:
            return _find_best_perm_by_linear_sum_assignment(metric_mtx, eval_func)
        if spk >= 3:
            rank_zero_warn(
                "In pit metric for speaker-num >= 3, we recommend installing scipy for better performance"
            )
        perm_idx, _ = _perm_tables(spk, device)
        # metric_mtx[:, i, p[i]] for each permutation p, averaged over i
        picked = metric_mtx[:, torch.arange(spk, device=device)[None, :], perm_idx]  # (batch, n_perms, spk)
        perm_scores = picked.mean(-1)
    else:
        def _per_batch(p):
            v = metric_func(preds[:, list(p)], target, **kwargs)
            return v.reshape(v.shape[0], -1).mean(-1)

        perm_scores = torch.stack([_per_batch(p) for p in perms], dim=-1)
    best_idx = torch.argmax(perm_scores, dim=-1) if eval_func == "max" else torch.argmin(perm_scores, dim=-1)
    best_metric = torch.gather(perm_scores, 1, best_idx[:, None])[:, 0]
    # speaker-wise scored prediction i against target p[i], so p is inverted; permutation-wise scored
    # preds[:, p] against the targets directly
    perm_arr, inverse = _perm_tables(spk, device)
    best_perm = (inverse if mode == "speaker-wise" else perm_arr)[best_idx].to(torch.int32)
    return best_metric, best_perm


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """``preds`` (batch, spk, ...) reordered along the sources by a PIT permutation (batch, spk)."""
    index = perm.long().reshape(*perm.shape, *([1] * (preds.ndim - 2))).expand(*perm.shape, *preds.shape[2:])
    return torch.gather(preds, 1, index)
