"""The port's panoptic quality (class and function, standard and modified) against the JAX package's.

Seeded label maps of (category, instance) pairs: stuff regions under thing
instances, the predictions a shifted, partly relabelled copy of the targets,
so that IoUs fall on both sides of 0.5. The TP, FP and FN counts are equal;
``iou_sum`` and PQ, SQ and RQ within rtol 1e-6.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.detection as jd
import metrics_tpu.functional.detection as jfd
import metrics_tpu_torch.detection as td
import metrics_tpu_torch.functional.detection as tfd

RTOL = 1e-6
THINGS, STUFFS = {1, 2, 3, 5}, {10, 11, 12}


def _maps(seed, batch=3, h=24, w=32, unknown=False):
    """(batch, h, w, 2) int64 target and prediction maps."""
    rng = np.random.RandomState(seed)
    target = np.zeros((batch, h, w, 2), np.int64)
    for b in range(batch):
        target[b, ..., 0] = rng.choice(sorted(STUFFS))
        target[b, : h // 2, :, 0] = rng.choice(sorted(STUFFS))
        target[b, ..., 1] = rng.randint(0, 3, (h, w))  # stuff instance ids are ignored
        for inst in range(rng.randint(1, 6)):
            y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
            dy, dx = rng.randint(3, h // 2), rng.randint(3, w // 2)
            target[b, y:y + dy, x:x + dx] = (rng.choice(sorted(THINGS)), inst)
    preds = np.roll(target, shift=(rng.randint(-3, 4), rng.randint(-3, 4)), axis=(1, 2))
    relabel = rng.rand(batch, h, w) < 0.03
    preds[relabel, 0] = rng.choice(sorted(THINGS | STUFFS), relabel.sum())
    if unknown:
        preds[0, :3, :3, 0] = 99
    return preds, target


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=0)


@pytest.mark.parametrize("cls", ["PanopticQuality", "ModifiedPanopticQuality"])
@pytest.mark.parametrize("returns", [{}, {"return_sq_and_rq": True}, {"return_per_class": True},
                                     {"return_sq_and_rq": True, "return_per_class": True}],
                         ids=["pq", "sq_rq", "per_class", "sq_rq_per_class"])
def test_panoptic_quality_matches_reference(cls, returns):
    port = getattr(td, cls)(THINGS, STUFFS, device="cpu", **returns)
    ref = getattr(jd, cls)(THINGS, STUFFS, **returns)
    for seed in range(3):
        preds, target = _maps(seed)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    for name in ("true_positives", "false_positives", "false_negatives"):
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert port.iou_sum.dtype == torch.float32
    _close(port.iou_sum, ref.iou_sum)
    assert int(port.true_positives.sum()) > 0 and int(port.false_positives.sum()) > 0
    got, want = port.compute(), ref.compute()
    assert tuple(got.shape) == np.asarray(want).shape
    _close(got, want)


@pytest.mark.parametrize("allow", [True, False])
def test_unknown_categories_allowed_and_refused(allow):
    preds, target = _maps(5, unknown=True)
    port = td.PanopticQuality(THINGS, STUFFS, allow_unknown_preds_category=allow, device="cpu")
    ref = jd.PanopticQuality(THINGS, STUFFS, allow_unknown_preds_category=allow)
    if not allow:
        with pytest.raises(ValueError, match=re.escape("Unknown categories found in `preds`: {99}")):
            port.update(torch.from_numpy(preds), torch.from_numpy(target))
        with pytest.raises(ValueError, match="Unknown categories"):
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        return
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_array_equal(port.false_positives.numpy(), np.asarray(ref.false_positives))
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("fn", ["panoptic_quality", "modified_panoptic_quality"])
def test_panoptic_functions_match_reference(fn):
    preds, target = _maps(6, batch=2)
    kw = {"things": THINGS, "stuffs": STUFFS, "return_sq_and_rq": True}
    _close(getattr(tfd, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw),
           getattr(jfd, fn)(jnp.asarray(preds), jnp.asarray(target), **kw))


@pytest.mark.parametrize("shape", [(24, 32, 2), (2, 2, 24, 32, 2)], ids=["one-image", "nested-batch"])
def test_panoptic_input_shapes_match_reference(shape):
    preds, target = _maps(7, batch=int(np.prod(shape[:-3])) if len(shape) > 3 else 1)
    preds, target = preds.reshape(shape), target.reshape(shape)
    port, ref = td.PanopticQuality(THINGS, STUFFS, device="cpu"), jd.PanopticQuality(THINGS, STUFFS)
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_array_equal(port.true_positives.numpy(), np.asarray(ref.true_positives))
    _close(port.compute(), ref.compute())


def test_panoptic_input_validation():
    with pytest.raises(ValueError, match="distinct"):
        td.PanopticQuality({1, 2}, {2, 3}, device="cpu")
    metric = td.PanopticQuality(THINGS, STUFFS, device="cpu")
    with pytest.raises(ValueError, match=r"\(..., H, W, 2\)"):
        metric.update(torch.zeros(1, 4, 4, 3, dtype=torch.long), torch.zeros(1, 4, 4, 3, dtype=torch.long))
    with pytest.raises(ValueError, match=r"\(..., H, W, 2\)"):
        metric.update(torch.zeros(1, 4, 4, 2, dtype=torch.long), torch.zeros(1, 4, 5, 2, dtype=torch.long))
