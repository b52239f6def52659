"""Shared inputs and comparisons of the stat-score and confusion-matrix parity tests; no tests here.

The port's metrics against the JAX package's on the same seeded numpy inputs:
each functional on one batch, each class over two updates (one where the JAX
package's own state cannot take a second, as noted), on the CPU.

Tolerances:

* counters and confusion matrices: integer-equal (int64 in the port, int32 or
  int64 in the JAX package: values and the integer kind are compared);
* scores: rtol 1e-6, atol 1e-7, in the JAX package's float dtype (float32
  under the defaults; float64 where the JAX package gives it under x64);
* calibration error and hinge loss: rtol 1e-5, atol 1e-6, because their float
  sums run in another order (a weighted count, a sum over samples);
* Cohen's kappa: atol 1e-6, since it is 1 - k for a float32 quotient k of sums
  of expected counts taken in another order, so an ulp of k (1.2e-7 near 1)
  is what the two may differ by however small kappa is;
* float states (calibration confidences, hinge and ranking sums, Dice's
  float counters) within the same tolerance as the score they feed.

Shapes stay fixed across cases (N = 48, C = 4, S = 3 positions for the
``samplewise`` averages), because the JAX side compiles for every new shape.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

import metrics_tpu.classification as jc
import metrics_tpu.functional.classification as jf
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional.classification as tf

N, C, S = 48, 4, 3
RTOL, ATOL = 1e-6, 1e-7
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6

TASK_FN = {"binary": "binary_", "multiclass": "multiclass_", "multilabel": "multilabel_"}
TASK_CLS = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.array(x))


def task_args(task):
    return {"num_classes": C} if task == "multiclass" else {"num_labels": C} if task == "multilabel" else {}


def scores(rng, shape, kind):
    """float32 probabilities (half of them on a grid of eighths: ties and values on thresholds), logits, or
    0/1 labels."""
    if kind == "logits":
        return (rng.randn(*shape) * 3).astype(np.float32)
    if kind == "labels":
        return rng.randint(0, 2, shape)
    fine = rng.rand(*shape).astype(np.float32)
    coarse = (rng.randint(0, 9, shape) / 8).astype(np.float32)
    return np.where(rng.rand(*shape) < 0.5, fine, coarse)


def inputs(task, kind="probs", ignore_index=None, seed=0, samplewise=False):
    """(preds, target) of the task: (N,) binary, (N, C) scores or (N,) labels multiclass, (N, C) multilabel;
    with ``samplewise`` one more trailing dimension of S positions. A fifth of the targets become
    ``ignore_index`` when it is given."""
    rng = np.random.RandomState(seed)
    extra = (S,) if samplewise else ()
    if task == "binary":
        preds, target = scores(rng, (N, *extra), kind), rng.randint(0, 2, (N, *extra))
    elif task == "multiclass":
        target = rng.randint(0, C, (N, *extra))
        preds = rng.randint(0, C, (N, *extra)) if kind == "labels" else scores(rng, (N, C, *extra), kind)
    else:
        preds, target = scores(rng, (N, C, *extra), kind), rng.randint(0, 2, (N, C, *extra))
    if ignore_index is not None:
        target = np.where(rng.rand(*target.shape) < 0.2, ignore_index, target)
    return preds, target


def assert_same(port, ref, rtol=RTOL, atol=ATOL, check_dtype=True):
    """Shapes equal; integers and booleans equal with the same kind; floats allclose in the same dtype."""
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref), (type(port), type(ref))
        for p, r in zip(port, ref):
            assert_same(p, r, rtol, atol, check_dtype)
        return
    assert isinstance(port, torch.Tensor), type(port)
    port_np, ref_np = port.detach().cpu().numpy(), np.asarray(ref)
    assert port_np.shape == ref_np.shape, (port_np.shape, ref_np.shape)
    if ref_np.dtype.kind in "biu":
        assert port_np.dtype.kind == ref_np.dtype.kind, (port.dtype, ref_np.dtype)
        np.testing.assert_array_equal(port_np, ref_np)
        return
    if check_dtype:
        assert str(port.dtype).replace("torch.", "") == str(ref_np.dtype), (port.dtype, ref_np.dtype)
    np.testing.assert_allclose(port_np.astype(np.float64), ref_np.astype(np.float64), rtol=rtol, atol=atol)


def assert_same_states(port, ref, rtol=RTOL, atol=ATOL):
    """Every state of the port's metric against the JAX metric's: the same names, values within tolerance."""
    ref_states = {k: getattr(ref, k) for k in ref._defaults}
    assert set(port.metric_state) == set(ref_states)
    for name, value in port.metric_state.items():
        want = ref_states[name]
        if isinstance(value, list):
            assert len(value) == len(want), name
            if value:
                assert_same(torch.cat([torch.atleast_1d(v) for v in value]),
                            np.concatenate([np.atleast_1d(np.asarray(w)) for w in want]), rtol, atol, False)
        else:
            assert_same(value, want, rtol, atol, False)


def run_functional(name, preds, target, args, rtol=RTOL, atol=ATOL):
    port = getattr(tf, name)(_t(preds), _t(target), **args)
    ref = getattr(jf, name)(_j(preds), _j(target), **args)
    assert_same(port, ref, rtol, atol)
    return port, ref


def run_class(name, batches, args, rtol=RTOL, atol=ATOL, wrapper_task=None):
    """The class ``name`` (or, with ``wrapper_task``, the task wrapper ``name`` for that task) over the
    batches in both packages: states and the computed value compared."""
    extra = {} if wrapper_task is None else {"task": wrapper_task}
    port = getattr(tc, name)(device="cpu", **extra, **args)
    ref = getattr(jc, name)(**extra, **args)
    for preds, target in batches:
        port.update(_t(preds), _t(target))
        ref.update(_j(preds), _j(target))
    assert_same_states(port, ref, rtol, atol)
    got, want = port.compute(), ref.compute()
    assert_same(got, want, rtol, atol)
    return port, ref
