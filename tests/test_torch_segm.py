"""The port's ``MeanAveragePrecision`` for masks (``iou_type="segm"`` and ``("bbox", "segm")``) against the
JAX package's.

The same seeded images go through both: filled ellipses as ground truths,
noisy copies of them and stray ellipses as detections, over a few image
sizes, so that one chunk of units holds a size group of fewer than four units
(the float64 quotient of the JAX package's host IoU, rounded to float32)
beside larger ones (the float32 quotient of its batched product). The
states' RLE bytes are equal; IoUs and match flags equal bit for bit; every
value of ``compute()`` within rtol 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.detection as jd
import metrics_tpu_torch.detection as td
import metrics_tpu_torch.detection.mean_ap as tmap
from metrics_tpu.functional.detection import map_matching as jmm
from metrics_tpu_torch.functional.detection import map_matching as tmm
from metrics_tpu_torch.interop import load_reference_state

MAP_RTOL = 1e-6
# 12 + 6 images of two sizes (float32 groups) and 2 of a third (a float64 group of at most 3 units)
SIZES = [(20, 24)] * 12 + [(24, 20)] * 6 + [(17, 23)] * 2


def _ellipses(rng, n, h, w):
    yy, xx = np.mgrid[:h, :w]
    cx, cy = rng.rand(n) * w, rng.rand(n) * h
    rx, ry = 1 + rng.rand(n) * w / 3, 1 + rng.rand(n) * h / 3
    return (((xx[None] + 0.5 - cx[:, None, None]) / rx[:, None, None]) ** 2
            + ((yy[None] + 0.5 - cy[:, None, None]) / ry[:, None, None]) ** 2) <= 1


def _box_of(masks):
    """The tight xyxy box of each mask (a unit box for an empty one)."""
    out = np.zeros((len(masks), 4))
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        out[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1] if len(xs) else [0, 0, 1, 1]
    return out


def _image(rng, size, n_classes=3, max_gt=5, crowd=0.15, with_area=False):
    h, w = size
    ng = rng.randint(0, max_gt + 1)
    gm = _ellipses(rng, ng, h, w)
    nd = ng + rng.randint(0, 4)
    dm = np.concatenate([gm ^ (rng.rand(ng, h, w) < 0.05), _ellipses(rng, nd - ng, h, w)])
    glab = rng.randint(0, n_classes, ng)
    dlab = np.concatenate([glab, rng.randint(0, n_classes, nd - ng)])
    target = {"masks": gm, "boxes": _box_of(gm), "labels": glab, "iscrowd": (rng.rand(ng) < crowd).astype(np.int64)}
    if with_area:
        target["area"] = gm.reshape(ng, h * w).sum(1) * 0.9
    return {"masks": dm, "boxes": _box_of(dm), "scores": rng.rand(nd).round(1), "labels": dlab}, target


def _images(seed, sizes=SIZES, **kw):
    rng = np.random.RandomState(seed)
    return [_image(rng, s, **kw) for s in sizes]


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _both(images, batches=2, **kw):
    port, ref = td.MeanAveragePrecision(device="cpu", **kw), jd.MeanAveragePrecision(**kw)
    for chunk in np.array_split(np.arange(len(images)), batches):
        part = [images[i] for i in chunk]
        port.update([_torch(p) for p, _ in part], [_torch(t) for _, t in part])
        ref.update([p for p, _ in part], [t for _, t in part])
    return port, ref


def _agree(got, want):
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        if isinstance(ref, dict):  # the IoU matrices: bit for bit
            assert sorted(got[key]) == sorted(ref), key
            for k in ref:
                g, w = got[key][k].numpy(), np.asarray(ref[k])
                assert g.dtype == w.dtype and g.shape == w.shape, (key, k)
                np.testing.assert_array_equal(g, w, err_msg=f"{key}{k}")
            continue
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref), rtol=MAP_RTOL, atol=0, err_msg=key)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("iou_type", ["segm", ("bbox", "segm")], ids=["segm", "bbox+segm"])
def test_segm_map_matches_reference(seed, iou_type):
    port, ref = _both(_images(seed), iou_type=iou_type, extended_summary=True)
    assert port.detection_rle == ref.detection_rle and port.gt_rle == ref.gt_rle
    got = port.compute()
    _agree(got, ref.compute())
    stages = port.last_evaluation["segm"]
    assert stages["f64_iou_units"] > 0 and stages["f32_iou_units"] > 0 and stages["chunks"] == 1
    assert stages["mask_iou_device_s"] is None and stages["match_device_s"] is None  # CUDA events, on the card only
    key = "map" if iou_type == "segm" else "segm_map"
    assert 0.05 < float(got[key]) < 1.0


@pytest.mark.parametrize("average", ["macro", "micro"])
def test_segm_class_metrics_match_reference(average):
    port, ref = _both(_images(2), iou_type="segm", class_metrics=True, average=average)
    _agree(port.compute(), ref.compute())


def test_segm_crowds_and_explicit_areas_match_reference():
    port, ref = _both(_images(3, crowd=0.4, with_area=True), iou_type="segm",
                      iou_thresholds=[0.3, 0.5, 0.9], max_detection_thresholds=[1, 2, 5])
    _agree(port.compute(), ref.compute())


def test_segm_over_several_chunks_matches_reference():
    """About 400 units: two chunks of 256, the first of small units only."""
    images = _images(4, sizes=[(10, 12)] * 130 + [(12, 10)] * 3, n_classes=5, max_gt=4)
    port, ref = _both(images, batches=3, iou_type="segm", extended_summary=True)
    _agree(port.compute(), ref.compute())
    assert port.last_evaluation["segm"]["chunks"] == 2


def test_segm_in_pieces_equals_one_piece(monkeypatch):
    images = _images(5)
    port, ref = _both(images, iou_type="segm", extended_summary=True)
    monkeypatch.setattr(tmap, "_MASK_STACK_BYTES", 1)  # one unit a piece
    got = port.compute()
    stages = port.last_evaluation["segm"]
    assert stages["mask_pieces"] == stages["f64_iou_units"] + stages["f32_iou_units"]
    _agree(got, ref.compute())


def _chunk_inputs(port, ref):
    """Both packages' units of the first chunk, with the port's padded arrays."""
    classes = sorted(set(np.concatenate(port.gt_label + port.detection_label).tolist()))
    units = port._build_units("segm", False, classes)
    assert [(u["img"], u["ki"], list(u["didx"])) for u in units] == \
        [(u["img"], u["ki"], list(u["didx"])) for u in ref._build_units("segm", False, classes)]
    order = sorted(range(len(units)), key=lambda i: (len(units[i]["didx"]), len(units[i]["gidx"])))
    chunk = [units[i] for i in order[:tmap._CHUNK_UNITS["segm"]]]
    ranges = np.asarray(list(tmap._BBOX_AREA_RANGES.values()))
    return chunk, port._pad_chunk(chunk, ranges)


def test_segm_ious_and_match_flags_equal_reference_bit_for_bit():
    port, ref = _both(_images(6, crowd=0.3), iou_type="segm")
    chunk, padded = _chunk_inputs(port, ref)
    _, _, det_valid, gt_valid, gt_crowd, gt_ignore, det_oor = padded
    d_cap, g_cap = det_valid.shape[1], gt_valid.shape[1]
    port._start_evaluation()
    got = port._segm_ious(chunk, d_cap, g_cap)
    want = np.asarray(jnp.asarray(ref._unit_ious(chunk, "segm", d_cap, g_cap)))
    assert port._segm_stats["f64_iou_units"] > 0 and port._segm_stats["f32_iou_units"] > 0
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    thr = np.asarray([0.5, 0.55, 0.75, 0.95], np.float32)
    t_dtm, t_dtig = tmm.match_units(got, *(torch.from_numpy(a) for a in (gt_valid, gt_crowd, gt_ignore, det_valid,
                                                                        det_oor)), torch.from_numpy(thr))
    j_dtm, j_dtig = jmm.match_units(jnp.asarray(want), *(jnp.asarray(a) for a in (gt_valid, gt_crowd, gt_ignore,
                                                                                 det_valid, det_oor)), jnp.asarray(thr))
    np.testing.assert_array_equal(t_dtm.numpy(), np.asarray(j_dtm))
    np.testing.assert_array_equal(t_dtig.numpy(), np.asarray(j_dtig))
    assert t_dtm.any() and (~t_dtm & torch.from_numpy(det_valid)[:, None, None, :]).any()


def test_batched_mask_iou_equals_reference():
    rng = np.random.RandomState(7)
    det = (rng.rand(3, 5, 60) < 0.5).astype(np.uint8)
    gt = (rng.rand(3, 4, 60) < 0.4).astype(np.uint8)
    gt[0, 1] = 0  # an empty ground truth
    crowd = rng.rand(3, 4) < 0.3
    got = tmm.batched_mask_iou(torch.from_numpy(det), torch.from_numpy(gt), torch.from_numpy(crowd))
    want = np.asarray(jmm.batched_mask_iou(jnp.asarray(det), jnp.asarray(gt), jnp.asarray(crowd)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_segm_input_errors():
    with pytest.raises(ValueError, match="iou_type"):
        td.MeanAveragePrecision(iou_type="keypoints", device="cpu")
    (p, t), = _images(8, sizes=[(8, 9)])
    metric = td.MeanAveragePrecision(iou_type="segm", device="cpu")
    with pytest.raises(ValueError, match="masks"):
        metric.update([{k: v for k, v in p.items() if k != "masks"}], [t])
    both = td.MeanAveragePrecision(iou_type=("bbox", "segm"), device="cpu")
    with pytest.raises(ValueError, match="boxes"):
        both.update([p], [{k: v for k, v in t.items() if k != "boxes"}])


def test_segm_masks_of_numpy_and_torch_agree():
    images = _images(9)
    from_numpy = td.MeanAveragePrecision(iou_type="segm", device="cpu")
    from_numpy.update([p for p, _ in images], [t for _, t in images])
    from_torch, _ = _both(images, batches=1, iou_type="segm")
    assert from_numpy.detection_rle == from_torch.detection_rle
    _agree(from_numpy.compute(), {k: v.numpy() for k, v in from_torch.compute().items()})


def test_segm_reference_state_loads_into_the_port():
    """The JAX package's state (each image's RLE objects as a numpy object array) computes in the port, and
    the port's updates go on from it."""
    images = _images(10)
    ref = jd.MeanAveragePrecision(iou_type=("bbox", "segm"))
    ref.update([p for p, _ in images[:12]], [t for _, t in images[:12]])
    ref.persistent(True)
    port = load_reference_state(td.MeanAveragePrecision(iou_type=("bbox", "segm"), device="cpu"), ref.state_dict())
    port.update([_torch(p) for p, _ in images[12:]], [_torch(t) for _, t in images[12:]])
    ref.update([p for p, _ in images[12:]], [t for _, t in images[12:]])
    _agree(port.compute(), ref.compute())
