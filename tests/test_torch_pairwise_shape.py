"""The port's pairwise distances and Procrustes disparity against the JAX package's, on the same seeded numpy
inputs.

Pairwise values are float32 matrix products or sums over the feature axis taken in another order: within
``PAIR_RTOL``/``PAIR_ATOL``. The inputs keep euclidean distances away from 0 where ``y`` is given; ``x``
against itself without a zeroed diagonal leaves on the diagonal the square root of the expansion's rounding
residue, which the tests bound instead of comparing. The manhattan distances taken in blocks of rows equal those
of one block, the Minkowski distances within 1 ulp.

Procrustes disparity and scale are within ``PROCRUSTES_RTOL``; the rotation ``U V^T`` does not depend on the
SVD's signs when the singular values are distinct, and is compared as a matrix within ``ROTATION_ATOL``. The
degenerate clouds repeat one point of quarter-integer coordinates, so that both packages' float32 means are
exact and both find the centred cloud all zero (for other values the guard follows each mean's rounding).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.pairwise as jp
import metrics_tpu.functional.shape as jfs
import metrics_tpu.shape as js
import metrics_tpu_torch.functional.pairwise as tp
import metrics_tpu_torch.functional.shape as tfs
import metrics_tpu_torch.shape as ts
from metrics_tpu_torch.functional.pairwise import metrics as tpm
from metrics_tpu_torch.interop import load_reference_state

PAIR_RTOL, PAIR_ATOL = 1e-5, 1e-5
PROCRUSTES_RTOL = 1e-5
ROTATION_ATOL = 1e-5
X64_RTOL = 1e-10

PAIR_FNS = ["pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity",
            "pairwise_manhattan_distance", "pairwise_minkowski_distance"]
REDUCTIONS = [None, "mean", "sum"]


def _xy(seed, n=20, m=15, d=8):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), (rng.randn(m, d) + 0.5).astype(np.float32)


def _close(port, ref, rtol, atol=0.0):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (port.shape, ref.shape, port.dtype, ref.dtype)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("zero_diagonal", [None, True, False])
@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", PAIR_FNS)
def test_pairwise_with_y_matches_reference(name, reduction, zero_diagonal):
    x, y = _xy(0)
    got = getattr(tp, name)(torch.from_numpy(x), torch.from_numpy(y), reduction=reduction,
                            zero_diagonal=zero_diagonal)
    want = getattr(jp, name)(jnp.asarray(x), jnp.asarray(y), reduction=reduction, zero_diagonal=zero_diagonal)
    _close(got, want, PAIR_RTOL, PAIR_ATOL)


@pytest.mark.parametrize("zero_diagonal", [None, True, False])
@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", PAIR_FNS)
def test_pairwise_of_x_with_itself_matches_reference(name, reduction, zero_diagonal):
    x, _ = _xy(1)
    got = getattr(tp, name)(torch.from_numpy(x), reduction=reduction, zero_diagonal=zero_diagonal)
    want = getattr(jp, name)(jnp.asarray(x), reduction=reduction, zero_diagonal=zero_diagonal)
    if name == "pairwise_euclidean_distance" and zero_diagonal is False:
        # the diagonal is sqrt of the expansion's residue in both: bounded, then left out of the comparison
        full_got = tp.pairwise_euclidean_distance(torch.from_numpy(x), zero_diagonal=False)
        full_want = np.asarray(jp.pairwise_euclidean_distance(jnp.asarray(x), zero_diagonal=False))
        assert float(full_got.diagonal().max()) < 1e-2 and float(np.diag(full_want).max()) < 1e-2
        off = ~np.eye(len(x), dtype=bool)
        _close(full_got.numpy()[off], full_want[off], PAIR_RTOL, PAIR_ATOL)
        return
    _close(got, want, PAIR_RTOL, PAIR_ATOL)


@pytest.mark.parametrize("exponent", [1, 2, 3, 2.5, 4.0])
def test_minkowski_exponents_match_reference(exponent):
    x, y = _xy(2)
    got = tp.pairwise_minkowski_distance(torch.from_numpy(x), torch.from_numpy(y), exponent=exponent)
    want = jp.pairwise_minkowski_distance(jnp.asarray(x), jnp.asarray(y), exponent=exponent)
    _close(got, want, PAIR_RTOL, PAIR_ATOL)


@pytest.mark.parametrize("rows_per_block", [1, 3, 7])
@pytest.mark.parametrize("exponent", [None, 3])
def test_blocked_distances_equal_one_block(monkeypatch, exponent, rows_per_block):
    x, y = _xy(3, n=23, m=11, d=6)
    fn = (lambda a, b: tp.pairwise_manhattan_distance(a, b)) if exponent is None else (
        lambda a, b: tp.pairwise_minkowski_distance(a, b, exponent=exponent))
    whole = fn(torch.from_numpy(x), torch.from_numpy(y))
    monkeypatch.setattr(tpm, "_CPU_BLOCK_ELEMENTS", rows_per_block * 11 * 6)
    assert tpm._distance_block_rows(23, 11, 6, torch.device("cpu")) == rows_per_block
    got = fn(torch.from_numpy(x), torch.from_numpy(y))
    if exponent is None:
        assert torch.equal(got, whole)
    else:  # the root ``** (1 / p)`` takes torch's vectorized or scalar path by the block's size: 1 ulp
        _close(got, whole.numpy(), 2.4e-7)


def test_integer_inputs_are_cast_to_float32_as_reference():
    rng = np.random.RandomState(4)
    x, y = rng.randint(-5, 5, (6, 3)), rng.randint(-5, 5, (4, 3))
    for name in PAIR_FNS:
        got = getattr(tp, name)(torch.from_numpy(x), torch.from_numpy(y))
        assert got.dtype == torch.float32
        _close(got, getattr(jp, name)(jnp.asarray(x), jnp.asarray(y)), PAIR_RTOL, PAIR_ATOL)


def test_bad_inputs_raise_as_in_reference():
    for mod, arr in ((tp, torch.from_numpy), (jp, jnp.asarray)):
        with pytest.raises(ValueError, match="2D tensor of shape `\\[N, d\\]`"):
            mod.pairwise_linear_similarity(arr(np.ones(3, np.float32)))
        with pytest.raises(ValueError, match="same as the last dimension"):
            mod.pairwise_linear_similarity(arr(np.ones((3, 2), np.float32)), arr(np.ones((3, 4), np.float32)))
        with pytest.raises(ValueError, match="exponent"):
            mod.pairwise_minkowski_distance(arr(np.ones((3, 2), np.float32)), exponent=0.5)
        with pytest.raises(ValueError, match="reduction"):
            mod.pairwise_cosine_similarity(arr(np.ones((3, 2), np.float32)), reduction="max")


@pytest.mark.parametrize("name", PAIR_FNS)
def test_float64_regime_keeps_float32_as_reference(name):
    """The JAX package casts the inputs to float32 in either regime; so does the port."""
    x, y = _xy(5)
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        got = getattr(tp, name)(torch.from_numpy(x.astype(np.float64)), torch.from_numpy(y.astype(np.float64)))
    finally:
        torch.set_default_dtype(previous)
    with jax.enable_x64(True):
        want = getattr(jp, name)(jnp.asarray(x.astype(np.float64)), jnp.asarray(y.astype(np.float64)))
    _close(got, want, PAIR_RTOL, PAIR_ATOL)


def _rotation(rng, d=3):
    q, r = np.linalg.qr(rng.randn(d, d))
    return q * np.sign(np.diag(r))


def _clouds(seed, n=8, m=17, d=3, degenerate=(2, 5)):
    """Pose-like clouds: each second cloud is the first rotated, scaled, shifted and noised; the clouds at
    ``degenerate`` have every point equal."""
    rng = np.random.RandomState(seed)
    pc1 = rng.randn(n, m, d)
    pc2 = np.stack([1.7 * pc1[i] @ _rotation(rng, d).T + rng.randn(d) for i in range(n)])
    pc2 = pc2 + 0.05 * rng.randn(*pc2.shape)
    for i in degenerate:
        pc1[i] = rng.randint(-8, 8, d) / 4
    return pc1.astype(np.float32), pc2.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_procrustes_matches_reference(seed):
    a, b = _clouds(seed)
    d, s, r = tfs.procrustes_disparity(torch.from_numpy(a), torch.from_numpy(b), return_all=True)
    jd, js_, jr = jfs.procrustes_disparity(jnp.asarray(a), jnp.asarray(b), return_all=True)
    _close(d, jd, PROCRUSTES_RTOL, 1e-7)
    _close(s, js_, PROCRUSTES_RTOL)
    _close(r, jr, 0.0, ROTATION_ATOL)
    _close(tfs.procrustes_disparity(torch.from_numpy(a), torch.from_numpy(b)), jd, PROCRUSTES_RTOL, 1e-7)


def test_degenerate_clouds_give_zero_disparity_unit_scale_and_identity():
    a, b = _clouds(3, degenerate=(0, 1, 2, 3, 4, 5, 6, 7))
    d, s, r = tfs.procrustes_disparity(torch.from_numpy(a), torch.from_numpy(b), return_all=True)
    assert torch.equal(d, torch.zeros(8)) and torch.equal(s, torch.ones(8, 1))
    assert torch.equal(r, torch.eye(3).expand(8, 3, 3))
    jd, js_, jr = jfs.procrustes_disparity(jnp.asarray(a), jnp.asarray(b), return_all=True)
    _close(d, jd, 0.0)
    _close(s, js_, 0.0)
    _close(r, jr, 0.0)


@pytest.mark.parametrize(("torch_dtype", "np_dtype"), [(torch.float16, np.float16), (torch.bfloat16, None)])
def test_half_inputs_are_computed_in_float32_as_reference(torch_dtype, np_dtype):
    a, b = _clouds(4)
    ta, tb = torch.from_numpy(a).to(torch_dtype), torch.from_numpy(b).to(torch_dtype)
    got = tfs.procrustes_disparity(ta, tb)
    assert got.dtype == torch.float32
    ja, jb = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if np_dtype is None else np_dtype) for x in (ta, tb))
    _close(got, jfs.procrustes_disparity(ja, jb), PROCRUSTES_RTOL, 1e-6)


def test_procrustes_float64_regime_matches_reference():
    a, b = (x.astype(np.float64) for x in _clouds(5))
    got = tfs.procrustes_disparity(torch.from_numpy(a), torch.from_numpy(b), return_all=True)
    with jax.enable_x64(True):
        want = jfs.procrustes_disparity(jnp.asarray(a), jnp.asarray(b), return_all=True)
        want = [np.asarray(w) for w in want]
    _close(got[0], want[0], X64_RTOL, 1e-14)
    _close(got[1], want[1], X64_RTOL)
    _close(got[2], want[2], 0.0, 1e-12)


def test_procrustes_bad_inputs_raise_as_in_reference():
    for fn, arr in ((tfs.procrustes_disparity, torch.from_numpy), (js.ProcrustesDisparity, None)):
        if arr is None:
            with pytest.raises(ValueError, match="reduction"):
                fn(reduction="max")
            with pytest.raises(ValueError, match="reduction"):
                ts.ProcrustesDisparity(reduction="max", device="cpu")
            continue
        with pytest.raises(ValueError, match="3D tensors"):
            fn(arr(np.ones((4, 3), np.float32)), arr(np.ones((4, 3), np.float32)))
        with pytest.raises(RuntimeError, match="same shape"):
            fn(arr(np.ones((2, 4, 3), np.float32)), arr(np.ones((2, 5, 3), np.float32)))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_procrustes_class_matches_reference(reduction):
    a, b = _clouds(6, n=12)
    port, ref = ts.ProcrustesDisparity(reduction=reduction, device="cpu"), js.ProcrustesDisparity(reduction=reduction)
    for sl in (slice(0, 5), slice(5, 11)):
        port.update(torch.from_numpy(a[sl]), torch.from_numpy(b[sl]))
        ref.update(jnp.asarray(a[sl]), jnp.asarray(b[sl]))
    port.update(torch.from_numpy(a[11]), torch.from_numpy(b[11]))  # one (M, D) pair
    ref.update(jnp.asarray(a[11]), jnp.asarray(b[11]))
    assert int(port.total) == int(ref.total) == 12
    _close(port.compute(), ref.compute(), PROCRUSTES_RTOL)


def test_procrustes_class_defaults_to_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.ProcrustesDisparity()


def test_procrustes_state_carried_from_reference_and_merged():
    a, b = _clouds(7, n=10)
    port, ref = ts.ProcrustesDisparity(device="cpu"), js.ProcrustesDisparity()
    ref.update(jnp.asarray(a[:4]), jnp.asarray(b[:4]))
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    other = ts.ProcrustesDisparity(device="cpu")
    other.update(torch.from_numpy(a[4:]), torch.from_numpy(b[4:]))
    port.merge_state(other)
    ref.update(jnp.asarray(a[4:]), jnp.asarray(b[4:]))
    assert port.total.dtype == torch.int64 and int(port.total) == 10
    _close(port.compute(), ref.compute(), PROCRUSTES_RTOL)
