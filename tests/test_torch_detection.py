"""The port's detection metrics (boxes) against the JAX package's.

The same seeded numpy images go through both packages: ``MeanAveragePrecision``
with crowd boxes, every area range, the xywh and cxcywh formats, class
metrics, micro averaging, other thresholds, explicit areas, IoUs exactly at a
threshold and images with no ground truth or no detection; the matching
function on its own, on inputs full of IoU ties; and the four IoU functions and
classes. MAP values agree within rtol 1e-6, as the JAX package's dryrun holds
them (the matching is float32 in both and makes the same decisions; the
accumulation is the same float64 numpy); IoUs within 1e-6; the match flags
exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.detection as jd
import metrics_tpu.functional.detection as jfd
import metrics_tpu_torch.detection as td
import metrics_tpu_torch.functional.detection as tfd
from metrics_tpu.functional.detection import map_matching as jmm
from metrics_tpu_torch.functional.detection import map_matching as tmm
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.parallel import allreduce_over_mesh

MAP_RTOL, IOU_ATOL = 1e-6, 1e-6


def _image(rng, n_classes=4, max_gt=6, crowd=0.1, scale=220.0, with_area=False):
    """One image: ground truths of every COCO area range, some crowd; jittered copies of them and false
    positives as detections; scores on a coarse grid, so that some tie."""
    ng = rng.randint(0, max_gt + 1)
    size = rng.choice([12.0, 50.0, 130.0], ng) * (0.6 + rng.rand(ng))
    xy = (rng.rand(ng, 2) * scale).round(1)
    gb = np.concatenate([xy, xy + size[:, None] * (0.6 + 0.8 * rng.rand(ng, 2))], axis=1).round(1)
    nd = ng + rng.randint(0, 4)
    db = np.concatenate([gb + rng.randn(ng, 4).round(1) * 2.5, (rng.rand(nd - ng, 4) * scale).round(1)])
    db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 1 + rng.rand(nd, 2) * 40)
    glab = rng.randint(0, n_classes, ng)
    dlab = np.concatenate([glab, rng.randint(0, n_classes, nd - ng)])
    target = {"boxes": gb, "labels": glab, "iscrowd": (rng.rand(ng) < crowd).astype(np.int64)}
    if with_area:
        target["area"] = ((gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1]) * 0.8).round(1)
    return {"boxes": db, "scores": rng.rand(nd).round(1), "labels": dlab}, target


def _images(seed, n=30, **kw):
    rng = np.random.RandomState(seed)
    return [_image(rng, **kw) for _ in range(n)]


def _convert(images, box_format):
    def fmt(b):
        if box_format == "xywh":
            return np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], axis=1)
        if box_format == "cxcywh":
            return np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], axis=1)
        return b
    return [({**p, "boxes": fmt(p["boxes"])}, {**t, "boxes": fmt(t["boxes"])}) for p, t in images]


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _both_map(images, batches=2, **kw):
    port, ref = td.MeanAveragePrecision(device="cpu", **kw), jd.MeanAveragePrecision(**kw)
    for chunk in np.array_split(np.arange(len(images)), batches):
        part = [images[i] for i in chunk]
        port.update([_torch(p) for p, _ in part], [_torch(t) for _, t in part])
        ref.update([p for p, _ in part], [t for _, t in part])
    return port, ref


def _agree_map(port, ref):
    assert sorted(port) == sorted(ref)
    for key, want in ref.items():
        got = port[key]
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), key
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=IOU_ATOL, err_msg=str(k))
            continue
        want = np.asarray(want)
        assert got.dtype == {np.dtype("float32"): torch.float32, np.dtype("int32"): torch.int32}[want.dtype], key
        np.testing.assert_allclose(got.numpy(), want, rtol=MAP_RTOL, atol=0, err_msg=key)


# ----------------------------------------------------------------------------- MeanAveragePrecision
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_matches_reference(seed):
    port, ref = _both_map(_images(seed))
    got = port.compute()
    _agree_map(got, ref.compute())
    assert 0.1 < float(got["map_50"]) < 1.0 and float(got["map_small"]) >= 0.0 and float(got["map_large"]) >= 0.0


@pytest.mark.parametrize("box_format", ["xywh", "cxcywh"])
def test_map_box_formats_match_reference(box_format):
    port, ref = _both_map(_convert(_images(3), box_format), box_format=box_format)
    _agree_map(port.compute(), ref.compute())
    xyxy, _ = _both_map(_images(3))
    _agree_map(port.compute(), {k: np.asarray(v) for k, v in xyxy.compute().items()})


@pytest.mark.parametrize("average", ["macro", "micro"])
def test_map_class_metrics_match_reference(average):
    port, ref = _both_map(_images(4), class_metrics=True, average=average)
    _agree_map(port.compute(), ref.compute())


@pytest.mark.parametrize("kw", [
    {"iou_thresholds": [0.3, 0.5, 0.9, 1.0]},
    {"rec_thresholds": [0.0, 0.25, 0.5, 0.75, 1.0]},
    {"max_detection_thresholds": [1, 3, 5]},
    {"extended_summary": True},
], ids=["iou_thresholds", "rec_thresholds", "max_detections", "extended_summary"])
def test_map_options_match_reference(kw):
    port, ref = _both_map(_images(5), **kw)
    _agree_map(port.compute(), ref.compute())


def test_map_crowd_and_explicit_areas_match_reference():
    port, ref = _both_map(_images(6, crowd=0.4, with_area=True))
    _agree_map(port.compute(), ref.compute())


def test_map_images_without_ground_truths_or_detections_match_reference():
    images = _images(7, n=12)
    images[2] = ({"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "labels": np.zeros(0, np.int64)}, images[2][1])
    images[5] = (images[5][0], {"boxes": np.zeros((0, 4)), "labels": np.zeros(0, np.int64),
                                "iscrowd": np.zeros(0, np.int64)})
    port, ref = _both_map(images)
    _agree_map(port.compute(), ref.compute())


def test_map_iou_exactly_at_the_thresholds():
    """Detections whose float32 IoU with their ground truth is exactly 0.5, 0.75 or 1: both packages match
    them at those thresholds; one ground truth is matched by two equal-IoU detections."""
    gt = np.array([[0.0, 0.0, 10.0, 20.0], [30.0, 0.0, 70.0, 10.0], [80.0, 0.0, 90.0, 10.0]])
    det = np.array([[0.0, 0.0, 10.0, 10.0],   # IoU 0.5
                    [30.0, 0.0, 60.0, 10.0],  # IoU 0.75
                    [80.0, 0.0, 90.0, 10.0],  # IoU 1
                    [0.0, 10.0, 10.0, 20.0]])  # IoU 0.5 with the first ground truth too
    images = [({"boxes": det, "scores": np.array([0.9, 0.8, 0.7, 0.9]), "labels": np.zeros(4, np.int64)},
               {"boxes": gt, "labels": np.zeros(3, np.int64)})]
    for kw in ({}, {"iou_thresholds": [0.5, 0.75, 1.0]}):
        port, ref = _both_map(images, batches=1, **kw)
        _agree_map(port.compute(), ref.compute())



def test_map_reference_state_loads_into_the_port():
    port, ref = _both_map(_images(8))
    ref.persistent(True)
    loaded = load_reference_state(td.MeanAveragePrecision(device="cpu"), ref.state_dict())
    assert loaded.gt_area == [None] * len(port.gt_area)
    _agree_map(loaded.compute(), ref.compute())


def test_map_ragged_rank_states_folded_equal_the_single_stream():
    """The JAX package's dryrun check: four ranks of uneven image counts (one empty) flattened to
    (concatenation, per-image count) pairs, folded by the fan-in and split back, equal the single stream."""
    rng = np.random.RandomState(9)
    rank_images = [[_image(rng) for _ in range(k)] for k in (3, 0, 5, 2)]
    ranks = []
    for images in rank_images:
        metric = td.MeanAveragePrecision(device="cpu")
        if images:
            metric.update([_torch(p) for p, _ in images], [_torch(t) for _, t in images])
        ranks.append(metric)
    flat = [_flat_map_state(m) for m in ranks]
    merged = allreduce_over_mesh(flat, {k: "cat" for k in flat[0]})
    folded = _unflatten_map_state(merged)
    single = td.MeanAveragePrecision(device="cpu")
    every = [img for images in rank_images for img in images]
    single.update([_torch(p) for p, _ in every], [_torch(t) for _, t in every])
    got, want = folded.compute(), single.compute()
    for key in ("map", "map_50", "map_75", "mar_100"):
        torch.testing.assert_close(got[key], want[key], rtol=MAP_RTOL, atol=0)


def _flat_map_state(m):
    def cat(xs, width, dtype):
        parts = [torch.from_numpy(np.asarray(x, dtype).reshape(-1, width) if width else np.asarray(x, dtype).reshape(-1))
                 for x in xs]
        return torch.cat(parts) if parts else torch.zeros((0, width) if width else (0,), dtype=torch.float32)

    return {"det_box": cat(m.detection_box, 4, np.float32), "det_score": cat(m.detection_score, 0, np.float32),
            "det_label": cat(m.detection_label, 0, np.int32),
            "det_count": torch.tensor([len(x) for x in m.detection_label], dtype=torch.int32),
            "gt_box": cat(m.gt_box, 4, np.float32), "gt_label": cat(m.gt_label, 0, np.int32),
            "gt_crowd": cat(m.gt_crowd, 0, np.int32),
            "gt_count": torch.tensor([len(x) for x in m.gt_label], dtype=torch.int32)}


def _unflatten_map_state(merged):
    m = td.MeanAveragePrecision(device="cpu")
    arrays = {k: v.numpy() for k, v in merged.items()}
    d_off = g_off = 0
    for nd, ng in zip(arrays["det_count"].astype(int), arrays["gt_count"].astype(int)):
        m.detection_box.append(arrays["det_box"][d_off:d_off + nd].astype(np.float64))
        m.detection_score.append(arrays["det_score"][d_off:d_off + nd].astype(np.float64))
        m.detection_label.append(arrays["det_label"][d_off:d_off + nd])
        m.detection_rle.append([])
        m.gt_box.append(arrays["gt_box"][g_off:g_off + ng].astype(np.float64))
        m.gt_label.append(arrays["gt_label"][g_off:g_off + ng])
        m.gt_crowd.append(arrays["gt_crowd"][g_off:g_off + ng].astype(bool))
        m.gt_rle.append([])
        m.gt_area.append(None)
        d_off, g_off = d_off + nd, g_off + ng
    m._update_count = 1
    return m


# ----------------------------------------------------------------------------- matching
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_match_units_equals_reference_on_ties(seed):
    """IoUs on a grid of a few values (ties everywhere, some exactly at a threshold), crowd and ignored
    ground truths, padding: the same match and ignore flags, bit for bit."""
    rng = np.random.RandomState(seed)
    u, d, g, a = 7, 9, 6, 4
    ious = rng.choice(np.float32([0.0, 0.3, 0.5, 0.55, 0.75, 0.9, 1.0]), (u, d, g))
    gt_valid = rng.rand(u, g) < 0.85
    gt_crowd = rng.rand(u, g) < 0.2
    gt_ignore = gt_crowd[:, None, :] | (rng.rand(u, a, g) < 0.25)
    det_valid = rng.rand(u, d) < 0.9
    det_oor = rng.rand(u, a, d) < 0.2
    thr = np.linspace(0.5, 0.95, 10).tolist() + [1.0]
    got = tmm.match_units(*(torch.from_numpy(np.asarray(x)) for x in (ious, gt_valid, gt_crowd, gt_ignore,
                                                                       det_valid, det_oor)),
                          torch.tensor(thr, dtype=torch.float64))
    want = jmm.match_units(*(jnp.asarray(x) for x in (ious, gt_valid, gt_crowd, gt_ignore, det_valid, det_oor)),
                           jnp.asarray(np.asarray(thr)))
    for port, ref in zip(got, want):
        assert port.dtype == torch.bool
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_batched_box_iou_equals_reference():
    rng = np.random.RandomState(11)
    db = (rng.rand(5, 8, 4) * 50).round(1)
    db[..., 2:] += db[..., :2]
    gb = (rng.rand(5, 6, 4) * 50).round(1)
    gb[..., 2:] += gb[..., :2]
    crowd = rng.rand(5, 6) < 0.3
    got = tmm.batched_box_iou(torch.from_numpy(db), torch.from_numpy(gb), torch.from_numpy(crowd))
    want = jmm.batched_box_iou(jnp.asarray(db), jnp.asarray(gb), jnp.asarray(crowd))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------------- IoU functions and classes
IOU_FUNCS = ["intersection_over_union", "generalized_intersection_over_union",
             "distance_intersection_over_union", "complete_intersection_over_union"]
IOU_CLASSES = ["IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
               "CompleteIntersectionOverUnion"]


def _boxes(rng, n):
    b = (rng.rand(n, 4) * 80).round(1)
    b[:, 2:] = b[:, :2] + 1 + (rng.rand(n, 2) * 60).round(1)
    return b.astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"aggregate": False}, {"iou_threshold": 0.2, "replacement_val": -3.0},
                                {"iou_threshold": -0.1, "aggregate": False}], ids=["mean", "matrix", "thr", "thr_neg"])
@pytest.mark.parametrize("fn", IOU_FUNCS)
def test_iou_functions_match_reference(fn, kw):
    rng = np.random.RandomState(12)
    preds, target = _boxes(rng, 7), _boxes(rng, 7)
    target[:3] = preds[:3] + rng.randn(3, 4).astype(np.float32)
    got = getattr(tfd, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    want = getattr(jfd, fn)(jnp.asarray(preds), jnp.asarray(target), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=IOU_ATOL)


@pytest.mark.parametrize("kw", [{}, {"iou_threshold": 0.4}, {"respect_labels": False}, {"class_metrics": True},
                                {"box_format": "xywh"}, {"box_format": "cxcywh"}],
                         ids=["plain", "thr", "any_label", "per_class", "xywh", "cxcywh"])
@pytest.mark.parametrize("cls", IOU_CLASSES)
def test_iou_classes_match_reference(cls, kw):
    rng = np.random.RandomState(13)
    images = []
    for _ in range(4):
        n = rng.randint(0, 5)
        gt = _boxes(rng, n)
        det = np.concatenate([gt + rng.randn(n, 4).astype(np.float32), _boxes(rng, 2)])
        images.append(({"boxes": det, "scores": rng.rand(n + 2).astype(np.float32), "labels": rng.randint(0, 3, n + 2)},
                       {"boxes": gt, "labels": rng.randint(0, 3, n)}))
    port, ref = getattr(td, cls)(device="cpu", **kw), getattr(jd, cls)(**kw)
    for p, t in images:
        port.update([_torch(p)], [_torch(t)])
        ref.update([{k: jnp.asarray(v) for k, v in p.items()}], [{k: jnp.asarray(v) for k, v in t.items()}])
    got, want = port.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=IOU_ATOL, err_msg=key)
