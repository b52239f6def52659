"""The port's Dice, generalized Dice, mean IoU and Hausdorff distance against the JAX package's, on the same
seeded numpy inputs.

The per-image, per-class counts (intersection, predicted and target pixels) are equal: the port counts index
inputs with ``scatter_add_`` into int64 bins, the JAX package sums float32 one-hots, and both are exact below
2^24. The Hausdorff distances are equal: the per-axis differences are combined in the JAX package's order, in
float64. Scores made from the counts are within rtol 1e-6: a mean over classes or samples may round its last
bit differently.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional.segmentation as jfs
import metrics_tpu.segmentation as js
import metrics_tpu_torch.functional.segmentation as tfs
import metrics_tpu_torch.segmentation as ts
from metrics_tpu.functional.segmentation import metrics as jm
from metrics_tpu_torch.functional.segmentation import metrics as tm
from metrics_tpu_torch.interop import load_reference_state

SCORE_RTOL = 1e-6
NUM_CLASSES = 4


def _index_maps(seed, n=3, shape=(20, 24), c=NUM_CLASSES):
    """Label maps with labels outside [0, c) (dropped by both), a class absent from one image's target and
    another from one image's prediction."""
    rng = np.random.RandomState(seed)
    preds = rng.randint(-1, c + 1, (n, *shape))
    target = rng.randint(0, c, (n, *shape))
    target[0][target[0] == 2] = 0
    preds[1][preds[1] == 3] = 0
    target[1][target[1] == 3] = 0
    return preds, target


def _one_hot_maps(seed, n=3, shape=(20, 24), c=NUM_CLASSES):
    rng = np.random.RandomState(seed)
    preds = rng.randint(0, 2, (n, c, *shape))
    target = rng.randint(0, 2, (n, c, *shape))
    target[:, 2] = 0  # a class empty in every target
    return preds, target


def _inputs(input_format, seed):
    return _index_maps(seed) if input_format == "index" else _one_hot_maps(seed)


def _close(port, ref, exact=False):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    if exact:
        np.testing.assert_array_equal(port, ref)
    else:
        np.testing.assert_allclose(port, ref, rtol=SCORE_RTOL, atol=0)


def _both(input_format, seed):
    p, t = _inputs(input_format, seed)
    return (torch.from_numpy(p), torch.from_numpy(t)), (jnp.asarray(p), jnp.asarray(t))


FORMATS = ["index", "one-hot"]


@pytest.mark.parametrize("input_format", FORMATS)
@pytest.mark.parametrize("include_background", [True, False])
def test_counts_equal_the_reference(input_format, include_background):
    (tp, tt), (jp, jt) = _both(input_format, 0)
    ref = jm._format_inputs(jp, jt, NUM_CLASSES, input_format, include_background)
    axes = tuple(range(2, ref[0].ndim))
    want = (jnp.sum(ref[0] * ref[1], axis=axes), jnp.sum(ref[0], axis=axes), jnp.sum(ref[1], axis=axes))
    got = tm._class_sums(tp, tt, NUM_CLASSES, input_format, include_background)
    for g, w in zip(got, want):
        _close(g, w, exact=True)
    port_fmt = tm._format_inputs(tp, tt, NUM_CLASSES, input_format, include_background)
    for g, w in zip(port_fmt, ref):
        _close(g, w, exact=True)


def test_float_index_labels_count_as_the_reference():
    p, t = _index_maps(1)
    p = p.astype(np.float32)
    p[0, 0, :4] = [0.5, 1.5, 2.0, 3.25]  # fractional labels match no class
    got = tm._class_sums(torch.from_numpy(p), torch.from_numpy(t), NUM_CLASSES, "index", True)
    ref = jm._format_inputs(jnp.asarray(p), jnp.asarray(t), NUM_CLASSES, "index", True)
    _close(got[1], jnp.sum(ref[0], axis=(2, 3)), exact=True)


@pytest.mark.parametrize("input_format", FORMATS)
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none", None])
@pytest.mark.parametrize("aggregation_level", ["samplewise", "global"])
def test_dice_score_matches_reference(input_format, include_background, average, aggregation_level):
    (tp, tt), (jp, jt) = _both(input_format, 2)
    args = (NUM_CLASSES, include_background, average, input_format, aggregation_level)
    _close(tfs.dice_score(tp, tt, *args), jfs.dice_score(jp, jt, *args))


@pytest.mark.parametrize("input_format", FORMATS)
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("per_class", [True, False])
@pytest.mark.parametrize("weight_type", ["square", "simple", "linear"])
def test_generalized_dice_score_matches_reference(input_format, include_background, per_class, weight_type):
    (tp, tt), (jp, jt) = _both(input_format, 3)
    args = (NUM_CLASSES, include_background, per_class, weight_type, input_format)
    _close(tfs.generalized_dice_score(tp, tt, *args), jfs.generalized_dice_score(jp, jt, *args))


def test_generalized_dice_takes_the_reference_s_weight_for_an_empty_class():
    """N = 3 > 1 and class 2 empty in the first image's target: its infinite weight is replaced by the batch
    maximum of class (0 * C + 2) // 3 = 0, not of class 2."""
    (tp, tt), (jp, jt) = _both("index", 4)
    got = tfs.generalized_dice_score(tp, tt, NUM_CLASSES, per_class=True, input_format="index")
    _close(got, jfs.generalized_dice_score(jp, jt, NUM_CLASSES, per_class=True, input_format="index"))
    _, _, target_sum = tm._class_sums(tp, tt, NUM_CLASSES, "index", True)
    weights = 1.0 / target_sum**2
    assert torch.isinf(weights[0, 2])
    finite = torch.where(torch.isinf(weights), torch.zeros_like(weights), weights)
    intersection, pred_sum, _ = tm._class_sums(tp, tt, NUM_CLASSES, "index", True)
    w = finite[:, 0].max()
    want = 2 * w * intersection[0, 2] / (w * (pred_sum[0, 2] + target_sum[0, 2]))
    torch.testing.assert_close(got[0, 2], want)


@pytest.mark.parametrize("input_format", FORMATS)
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("per_class", [True, False])
def test_mean_iou_matches_reference(input_format, include_background, per_class):
    (tp, tt), (jp, jt) = _both(input_format, 5)
    args = (NUM_CLASSES, include_background, per_class, input_format)
    _close(tfs.mean_iou(tp, tt, *args), jfs.mean_iou(jp, jt, *args))


def test_input_checks():
    (tp, tt), _ = _both("index", 6)
    with pytest.raises(ValueError, match="input_format"):
        tfs.mean_iou(tp, tt, NUM_CLASSES, input_format="labels")
    with pytest.raises(ValueError, match="input_format"):
        tfs.hausdorff_distance(tp, tt, NUM_CLASSES, input_format="labels")
    with pytest.raises(ValueError, match="`num_classes` must be provided"):
        tfs.dice_score(tp, tt, input_format="index")
    with pytest.raises(ValueError, match="`num_classes` must be provided"):
        tfs.mean_iou(tp, tt, input_format="index")
    with pytest.raises(ValueError, match="weight_type"):
        tfs.generalized_dice_score(tp, tt, NUM_CLASSES, weight_type="cubic", input_format="index")
    with pytest.raises(ValueError, match="average"):
        tfs.dice_score(tp, tt, NUM_CLASSES, average="samples", input_format="index")
    with pytest.raises(ValueError, match="aggregation_level"):
        tfs.dice_score(tp, tt, NUM_CLASSES, input_format="index", aggregation_level="batch")
    with pytest.raises(ValueError, match="distance_metric"):
        tfs.hausdorff_distance(tp, tt, NUM_CLASSES, distance_metric="cosine", input_format="index")
    for kwargs in ({"average": "samples"}, {"input_format": "labels"}, {"aggregation_level": "batch"}):
        with pytest.raises(ValueError):
            ts.DiceScore(NUM_CLASSES, device="cpu", **kwargs)


# ----------------------------------------------------------------------------- Hausdorff
@pytest.mark.parametrize("input_format", FORMATS)
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("distance_metric", ["euclidean", "chessboard", "taxicab"])
@pytest.mark.parametrize("directed", [False, True])
def test_hausdorff_2d_equals_the_reference(input_format, include_background, distance_metric, directed):
    (tp, tt), (jp, jt) = _both(input_format, 7)
    args = (NUM_CLASSES, include_background, distance_metric, (0.7, 1.3), directed, input_format)
    _close(tfs.hausdorff_distance(tp, tt, *args), jfs.hausdorff_distance(jp, jt, *args), exact=True)


def _volumes(seed):
    """Two volumes of 3 labels in boxes; the second image's class 2 is absent from its prediction (inf) and
    class 3 from both (0)."""
    rng = np.random.RandomState(seed)
    target = np.zeros((2, 13, 15, 17), np.int64)
    target[:, 2:9, 3:12, 1:9] = 1
    target[0, 5:12, 1:6, 8:16] = 2
    target[1, 4:10, 8:14, 9:15] = 2
    target[0, 9:12, 10:14, 2:6] = 3
    preds = np.roll(target, 1, axis=1)
    preds[0] = np.roll(preds[0], -2, axis=2)
    preds[1][preds[1] == 2] = 0
    preds[0, rng.rand(13, 15, 17) < 0.02] = 1
    return preds, target


@pytest.mark.parametrize("distance_metric", ["euclidean", "chessboard", "taxicab"])
@pytest.mark.parametrize("spacing", [None, (1.0, 0.5, 2.0)])
@pytest.mark.parametrize("directed", [False, True])
def test_hausdorff_3d_equals_the_reference(distance_metric, spacing, directed):
    p, t = _volumes(8)
    args = (NUM_CLASSES, False, distance_metric, spacing, directed, "index")
    got = tfs.hausdorff_distance(torch.from_numpy(p), torch.from_numpy(t), *args)
    _close(got, jfs.hausdorff_distance(jnp.asarray(p), jnp.asarray(t), *args), exact=True)
    assert torch.isinf(got[1, 1]) and got[1, 2] == 0


def test_hausdorff_blocks_give_the_same_maxima(monkeypatch):
    """Row blocks of 7 points give the single block's value."""
    (tp, tt), (jp, jt) = _both("index", 9)
    want = tfs.hausdorff_distance(tp, tt, NUM_CLASSES, input_format="index")
    monkeypatch.setattr(tm, "_CPU_DISTANCE_BLOCK", 7 * 200)
    got = tfs.hausdorff_distance(tp, tt, NUM_CLASSES, input_format="index")
    _close(got, np.asarray(want), exact=True)
    _close(got, jfs.hausdorff_distance(jp, jt, NUM_CLASSES, input_format="index"), exact=True)


@pytest.mark.parametrize("shape", [(9,), (6, 7), (4, 5, 6)])
def test_edges_equal_the_reference(shape):
    mask = np.random.RandomState(10).rand(*shape) < 0.6
    _close(tm._edges(torch.from_numpy(mask)), jm._edges(jnp.asarray(mask)), exact=True)


# ----------------------------------------------------------------------------- classes
CLASSES = [
    ("DiceScore", {"average": "micro", "input_format": "index"}),
    ("DiceScore", {"average": "macro", "input_format": "one-hot", "include_background": False}),
    ("DiceScore", {"average": "weighted", "input_format": "index", "aggregation_level": "global"}),
    ("DiceScore", {"average": "none", "input_format": "one-hot"}),
    ("GeneralizedDiceScore", {"input_format": "index"}),
    ("GeneralizedDiceScore", {"input_format": "one-hot", "per_class": True, "weight_type": "simple",
                              "include_background": False}),
    ("MeanIoU", {"input_format": "index", "per_class": True}),
    ("MeanIoU", {"input_format": "one-hot", "include_background": False}),
    ("HausdorffDistance", {"input_format": "index", "distance_metric": "chessboard"}),
    ("HausdorffDistance", {"input_format": "one-hot", "include_background": True, "directed": True}),
]
CLASS_IDS = [f"{name}-{i}" for i, (name, _) in enumerate(CLASSES)]


def _pair(name, kwargs):
    return getattr(ts, name)(NUM_CLASSES, device="cpu", **kwargs), getattr(js, name)(NUM_CLASSES, **kwargs)


@pytest.mark.parametrize(("name", "kwargs"), CLASSES, ids=CLASS_IDS)
def test_classes_over_several_updates(name, kwargs):
    port, ref = _pair(name, kwargs)
    for seed in (11, 12, 13):
        (tp, tt), (jp, jt) = _both(kwargs["input_format"], seed)
        port.update(tp, tt)
        ref.update(jp, jt)
    for key, value in ref.metric_state.items():
        got = port.metric_state[key]
        if isinstance(value, list):
            got, value = torch.cat(got), jnp.concatenate(value)
        # counters and Dice's per-sample counts equal; sums of float scores within SCORE_RTOL
        counts = got.dtype == torch.int64 or name == "DiceScore"
        _close(got.to(torch.int32) if got.dtype == torch.int64 else got, value, exact=counts)
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize(("name", "kwargs"), CLASSES, ids=CLASS_IDS)
def test_reference_state_loads_into_the_port(name, kwargs):
    port, ref = _pair(name, kwargs)
    for seed in (14, 15):
        ref.update(*_both(kwargs["input_format"], seed)[1])
    ref.persistent(True)
    load_reference_state(port, ref.state_dict())
    assert port.update_count == 2
    (tp, tt), (jp, jt) = _both(kwargs["input_format"], 16)
    ref.update(jp, jt)
    port.update(tp, tt)
    _close(port.compute(), ref.compute())


def _fed(make, seeds):
    metric = make()
    for seed in seeds:
        metric.update(*_both("index", seed)[0])
    return metric


SPLIT = [
    ("DiceScore", lambda: ts.DiceScore(NUM_CLASSES, average="macro", input_format="index", device="cpu")),
    ("DiceScore-global", lambda: ts.DiceScore(NUM_CLASSES, input_format="index", aggregation_level="global",
                                              device="cpu")),
    ("DiceScore-none", lambda: ts.DiceScore(NUM_CLASSES, average="none", input_format="index", device="cpu")),
    ("GeneralizedDiceScore", lambda: ts.GeneralizedDiceScore(NUM_CLASSES, input_format="index", device="cpu")),
    ("MeanIoU", lambda: ts.MeanIoU(NUM_CLASSES, per_class=True, input_format="index", device="cpu")),
    ("HausdorffDistance", lambda: ts.HausdorffDistance(NUM_CLASSES, input_format="index", device="cpu")),
]


@pytest.mark.parametrize(("label", "make"), SPLIT, ids=[s[0] for s in SPLIT])
def test_split_update_merge_equals_the_single_stream(label, make):
    whole = _fed(make, (17, 18, 19))
    shards = [_fed(make, (s,)) for s in (17, 18, 19)]
    for shard in reversed(shards[:-1]):  # an incoming state's samples go first
        shards[-1].merge_state(shard)
    _close(shards[-1].compute(), whole.compute().numpy())


@pytest.mark.parametrize(("label", "make"), SPLIT, ids=[s[0] for s in SPLIT])
def test_sync_through_a_fake_dist_sync_fn_equals_the_single_stream(label, make):
    port = _fed(make, (20,))
    peers = [dict(_fed(make, (s,)).metric_state) for s in (21, 22)]

    def sync_fn(states, group):
        return [[local] + [list(peer.values())[i] for peer in peers] for i, local in enumerate(states)]

    port.sync(dist_sync_fn=sync_fn, distributed_available=True)
    _close(port._compute_impl(), _fed(make, (20, 21, 22)).compute().numpy())
    port.unsync()
    assert port.update_count == 1
