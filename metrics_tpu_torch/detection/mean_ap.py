"""Mean average precision for object detection and instance segmentation, COCO's protocol
(counterpart of ``metrics_tpu/detection/mean_ap.py``), for ``iou_type`` ``"bbox"``, ``"segm"`` or both.

The work is split as the JAX package splits it:

* the per-image states are host float64 numpy arrays and, for ``"segm"``,
  lists of COCO RLE objects (list states, gathered without a reduction); an
  update finds each mask's run lengths on the mask's own device and
  compresses them in the host codec (:mod:`metrics_tpu_torch.detection.rle`);
* the evaluation units, (image, class) pairs, are padded into chunks; each
  chunk's IoU matrices and its greedy matching run on the metric's device
  (:mod:`metrics_tpu_torch.functional.detection.map_matching`), in float32.
  Mask IoUs keep the JAX package's split: in each chunk of 256 units the
  units are grouped by mask size; a group of fewer than four units gets the
  float64 quotient of the JAX package's host ``rle_iou``, rounded to float32,
  and a larger one the float32 quotient of its batched product. Both kinds
  are expanded from their runs on the device and go through
  :func:`~metrics_tpu_torch.functional.detection.map_matching.batched_mask_iou`
  in pieces of at most ``_MASK_STACK_BYTES``: the intersections and areas are
  exact integers either way, so only the quotient's type differs;
* the accumulation over units (a stable merge sort of the scores, cumulative
  sums, the 101-point interpolation) is host numpy in float64.

After each evaluation ``last_evaluation[iou_type]`` holds the number of units
and chunks and the wall time of each stage: building the units, padding the
chunks, for masks the IoUs (with the host's layout of the runs apart, the
card's time for the pieces from CUDA events, and the units of each quotient
type), the matching with its copy back to the host (and the card's time for
it from CUDA events), and the accumulation.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.detection.rle import _counts_of, masks_to_rles
from metrics_tpu_torch.functional.detection.map_matching import batched_box_iou, batched_mask_iou, match_units
from metrics_tpu_torch.metric import Metric

Tensor = torch.Tensor

__all__ = ["MeanAveragePrecision"]

_BBOX_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
_CHUNK_UNITS = {"bbox": 2048, "segm": 256}
_SMALL_GROUP_UNITS = 4  # a mask-size group of fewer units gets the float64 quotient of the JAX package's host IoU
_MASK_STACK_BYTES = 1 << 30  # device memory of one piece of the dense mask stack
# bytes a mask pixel takes at the peak of a piece: the uint8 masks and repeat_interleave's int64 index while they
# expand, more than their uint8 and float32 copies in batched_mask_iou
_BYTES_PER_MASK_PIXEL = 9


def _recorded_event(device: torch.device) -> Optional[Any]:
    """A timing event recorded on ``device``'s current stream; None off the card."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _host(x: Any, dtype: Any = None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


class MeanAveragePrecision(Metric):
    """Mean average precision (and recall) of object detection under COCO's protocol.

    ``update`` takes one dict per image: predictions with ``boxes``, ``scores``
    and ``labels``; targets with ``boxes`` and ``labels``, and optionally
    ``iscrowd`` and ``area``. With ``iou_type="segm"`` the dicts carry
    ``masks`` of shape ``(n, h, w)`` instead of ``boxes``, and both with
    ``("bbox", "segm")``. ``compute`` returns ``map``, ``map_50``,
    ``map_75``, the small, medium and large maps and mars, and ``mar_<k>`` for
    each of ``max_detection_thresholds``, as float32 tensors, with
    ``classes``; per class too with ``class_metrics``. With two IoU types each
    key is prefixed with ``bbox_`` or ``segm_``.

    >>> preds = [{"boxes": torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
    ...           "scores": torch.tensor([0.536]), "labels": torch.tensor([0])}]
    >>> target = [{"boxes": torch.tensor([[214.0, 41.0, 562.0, 285.0]]), "labels": torch.tensor([0])}]
    >>> metric = MeanAveragePrecision(device="cpu")
    >>> metric.update(preds, target)
    >>> round(float(metric.compute()["map_50"]), 4)
    1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    # the list states hold host numpy arrays, None areas and lists of RLE objects, not tensors
    _host_list_states = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: Union[str, Tuple[str, ...]] = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        extended_summary: bool = False,
        average: str = "macro",
        backend: str = "native",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if box_format not in ("xyxy", "xywh", "cxcywh"):
            raise ValueError(f"Expected argument `box_format` to be one of ('xyxy', 'xywh', 'cxcywh') but got {box_format}")
        if isinstance(iou_type, str):
            iou_type = (iou_type,)
        for t in iou_type:
            if t not in ("bbox", "segm"):
                raise ValueError(f"Expected argument `iou_type` to be one of ('bbox', 'segm') but got {t}")
        if average not in ("macro", "micro"):
            raise ValueError(f"Expected argument `average` to be one of ('macro', 'micro') but got {average}")
        self.box_format = box_format
        self.iou_type = tuple(iou_type)
        self.iou_thresholds = iou_thresholds or np.linspace(0.5, 0.95, 10).tolist()
        self.rec_thresholds = rec_thresholds or np.linspace(0.0, 1.00, 101).tolist()
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        self.class_metrics = class_metrics
        self.extended_summary = extended_summary
        self.average = average
        self.last_evaluation: Dict[str, Dict[str, Any]] = {}
        self._start_evaluation()

        for name in ("detection_box", "detection_score", "detection_label", "detection_rle",
                     "gt_box", "gt_label", "gt_crowd", "gt_area", "gt_rle"):
            self.add_state(name, [], dist_reduce_fx=None)

    # ------------------------------------------------------------------ input handling
    def _to_xyxy(self, boxes: np.ndarray) -> np.ndarray:
        if self.box_format == "xyxy" or boxes.size == 0:
            return boxes
        out = boxes.copy()
        if self.box_format == "xywh":
            out[:, 2:] = boxes[:, :2] + boxes[:, 2:]
        else:  # cxcywh
            out[:, :2] = boxes[:, :2] - boxes[:, 2:] / 2
            out[:, 2:] = boxes[:, :2] + boxes[:, 2:] / 2
        return out

    def update(self, preds: Sequence[Dict[str, Any]], target: Sequence[Dict[str, Any]]) -> None:
        """Append each image's detections and ground truths to the host states; masks become RLE objects."""
        if len(preds) != len(target):
            raise ValueError("Expected argument `preds` and `target` to have the same length")
        needs_boxes, needs_masks = "bbox" in self.iou_type, "segm" in self.iou_type
        keys = (("boxes",) if needs_boxes else ()) + (("masks",) if needs_masks else ())
        for item in preds:
            for key in keys + ("scores", "labels"):
                if key not in item:
                    raise ValueError(f"Expected all dicts in `preds` to contain the `{key}` key")
        for item in target:
            for key in keys + ("labels",):
                if key not in item:
                    raise ValueError(f"Expected all dicts in `target` to contain the `{key}` key")
        for p, t in zip(preds, target):
            n_det = len(_host(p["labels"]).reshape(-1))
            n_gt = len(_host(t["labels"]).reshape(-1))
            if needs_boxes:
                self.detection_box.append(self._to_xyxy(_host(p["boxes"], np.float64).reshape(-1, 4)))
                self.gt_box.append(self._to_xyxy(_host(t["boxes"], np.float64).reshape(-1, 4)))
            else:
                self.detection_box.append(np.zeros((n_det, 4)))
                self.gt_box.append(np.zeros((n_gt, 4)))
            self.detection_score.append(_host(p["scores"], np.float64).reshape(-1))
            self.detection_label.append(_host(p["labels"]).reshape(-1))
            self.gt_label.append(_host(t["labels"]).reshape(-1))
            self.detection_rle.append(masks_to_rles(p["masks"]) if needs_masks else [])
            self.gt_rle.append(masks_to_rles(t["masks"]) if needs_masks else [])
            self.gt_crowd.append(_host(t.get("iscrowd", np.zeros(n_gt))).reshape(-1).astype(bool))
            area = t.get("area")
            self.gt_area.append(None if area is None else _host(area, np.float64).reshape(-1))

    # ------------------------------------------------------------------ evaluation core
    def _start_evaluation(self) -> None:
        """Empty the cache of decompressed run lengths and zero the mask-IoU counters."""
        self._counts_cache = {}
        self._segm_stats = dict.fromkeys(("rle_decode_s", "f64_iou_units", "f32_iou_units", "mask_pieces"), 0)
        self._piece_events: List[Tuple[Any, Any]] = []

    def _counts(self, kind: str, img: int, j: int) -> np.ndarray:
        """The run lengths of one mask (``kind`` "det" or "gt"), decompressed once per evaluation."""
        key = (kind, img, j)
        counts = self._counts_cache.get(key)
        if counts is None:
            rles = self.detection_rle if kind == "det" else self.gt_rle
            counts = self._counts_cache[key] = _counts_of(rles[img][j])
        return counts

    def _areas(self, i_type: str, img: int) -> Tuple[np.ndarray, np.ndarray]:
        """(detection areas, ground-truth areas) of one image under ``i_type``; an explicit ground-truth area
        wins. A mask's area is its foreground pixel count."""
        if i_type == "bbox":
            db = self.detection_box[img]
            det = (db[:, 2] - db[:, 0]) * (db[:, 3] - db[:, 1]) if len(db) else np.zeros(0)
            gb = self.gt_box[img]
            gt = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1]) if len(gb) else np.zeros(0)
        else:
            det = np.asarray([self._counts("det", img, j)[1::2].sum() for j in range(len(self.detection_rle[img]))],
                             dtype=np.float64)
            gt = np.asarray([self._counts("gt", img, j)[1::2].sum() for j in range(len(self.gt_rle[img]))],
                            dtype=np.float64)
        if self.gt_area[img] is not None:
            gt = self.gt_area[img]
        return np.asarray(det, dtype=np.float64), np.asarray(gt, dtype=np.float64)

    def _build_units(self, i_type: str, micro: bool, classes: List[int]) -> List[Dict[str, Any]]:
        """The (image, class) units with a detection or a ground truth, detections sorted by score.

        Units come image by image, classes in ascending order, as in the JAX
        package; only the classes present in an image are visited.
        """
        max_det_cap = max(self.max_detection_thresholds)
        class_index = {c: k for k, c in enumerate(classes)}
        units = []
        for img in range(len(self.detection_box)):
            dlab = np.asarray(self.detection_label[img]).reshape(-1)
            glab = np.asarray(self.gt_label[img]).reshape(-1)
            if micro:
                present = [(0, None)] if len(dlab) or len(glab) else []
            else:
                present = [(class_index[c], c) for c in np.union1d(dlab, glab).tolist()]
            det_areas, gt_areas = self._areas(i_type, img)
            for ki, cls in present:
                didx = np.arange(len(dlab)) if cls is None else np.nonzero(dlab == cls)[0]
                gidx = np.arange(len(glab)) if cls is None else np.nonzero(glab == cls)[0]
                scores = self.detection_score[img][didx]
                order = np.argsort(-scores, kind="stable")[:max_det_cap]
                didx = didx[order]
                units.append({
                    "ki": ki, "img": img, "didx": didx, "scores": scores[order], "det_areas": det_areas[didx],
                    "gidx": gidx, "gt_areas": gt_areas[gidx], "gt_crowd": self.gt_crowd[img][gidx],
                })
        return units

    def _pad_chunk(self, chunk: List[Dict[str, Any]], ranges: np.ndarray) -> Tuple[np.ndarray, ...]:
        """One chunk of units padded to its largest unit, on the host: (detection boxes, ground-truth boxes,
        detection valid, ground truth valid, crowd, ground truth ignored per area range, detection out of
        each area range)."""
        u_n, a_n = len(chunk), len(ranges)
        d_cap = max(max(len(u["didx"]) for u in chunk), 1)
        g_cap = max(max(len(u["gidx"]) for u in chunk), 1)
        db = np.zeros((u_n, d_cap, 4))
        gb = np.zeros((u_n, g_cap, 4))
        det_valid = np.zeros((u_n, d_cap), bool)
        gt_valid = np.zeros((u_n, g_cap), bool)
        gt_crowd = np.zeros((u_n, g_cap), bool)
        gt_ignore = np.zeros((u_n, a_n, g_cap), bool)
        det_oor = np.zeros((u_n, a_n, d_cap), bool)
        for row, u in enumerate(chunk):
            nd, ng = len(u["didx"]), len(u["gidx"])
            db[row, :nd] = self.detection_box[u["img"]][u["didx"]]
            gb[row, :ng] = self.gt_box[u["img"]][u["gidx"]]
            det_valid[row, :nd] = True
            gt_valid[row, :ng] = True
            gt_crowd[row, :ng] = u["gt_crowd"]
            out_rng_gt = (u["gt_areas"][None, :] < ranges[:, :1]) | (u["gt_areas"][None, :] > ranges[:, 1:])
            gt_ignore[row, :, :ng] = u["gt_crowd"][None, :] | out_rng_gt
            det_oor[row, :, :nd] = (u["det_areas"][None, :] < ranges[:, :1]) | (u["det_areas"][None, :] > ranges[:, 1:])
        return db, gb, det_valid, gt_valid, gt_crowd, gt_ignore, det_oor

    def _mask_runs(self, slots: List[Optional[Tuple[str, int, int]]], pixels: int) -> Tuple[np.ndarray, ...]:
        """The runs of ``slots``' column-major masks of ``pixels`` pixels each, laid end to end on the host: the
        value of each run (0 or 1, background first) and its length; a ``None`` slot is an empty mask (one
        background run)."""
        t0 = time.perf_counter()
        empty = np.asarray([pixels], dtype=np.int64)
        counts = [empty if slot is None else self._counts(*slot) for slot in slots]
        lengths = np.asarray([len(c) for c in counts])
        flat = np.concatenate(counts)
        starts = np.cumsum(lengths) - lengths
        sums = np.add.reduceat(flat, starts) if len(flat) else np.zeros(len(counts), np.int64)
        if (lengths == 0).any() or (sums != pixels).any():
            bad = int(np.nonzero((lengths == 0) | (sums != pixels))[0][0])
            raise ValueError(f"RLE counts sum to {int(flat[starts[bad]:starts[bad] + lengths[bad]].sum())},"
                             f" expected {pixels}")
        values = ((np.arange(len(flat)) - np.repeat(starts, lengths)) & 1).astype(np.uint8)
        self._segm_stats["rle_decode_s"] += time.perf_counter() - t0
        return values, flat

    def _dense_masks(self, values: np.ndarray, lengths: np.ndarray, size: int) -> Tensor:
        """The runs expanded into ``size`` uint8 pixels on the metric's device."""
        if self.device.type == "cpu":  # numpy's repeat is several times faster than torch's on the host
            return torch.from_numpy(np.repeat(values, lengths))
        return torch.repeat_interleave(torch.from_numpy(values).to(self.device),
                                       torch.from_numpy(lengths).to(self.device), output_size=size)

    def _segm_ious(self, chunk: List[Dict[str, Any]], d_cap: int, g_cap: int) -> Tensor:
        """``(U, d_cap, g_cap)`` float32 mask IoUs of one chunk of units, on the metric's device.

        The units with a detection and a ground truth are grouped by mask size, as the JAX package groups
        them. A group of fewer than ``_SMALL_GROUP_UNITS`` gets the float64 quotient that the JAX package's host
        ``rle_iou`` gives it, rounded to float32; a larger one the float32 quotient of the JAX package's
        batched product. Each group goes through ``batched_mask_iou`` in pieces of units whose dense masks fit
        ``_MASK_STACK_BYTES`` (pieces along the unit axis change no value).
        """
        ious = torch.zeros((len(chunk), d_cap, g_cap), dtype=torch.float32, device=self.device)
        by_shape: Dict[Tuple[int, int], List[int]] = {}
        for row, u in enumerate(chunk):
            if len(u["didx"]) and len(u["gidx"]):
                by_shape.setdefault(tuple(self.gt_rle[u["img"]][u["gidx"][0]]["size"]), []).append(row)
        stats = self._segm_stats
        for (h, w), members in by_shape.items():
            small = len(members) < _SMALL_GROUP_UNITS
            pixels = h * w
            piece = max(1, _MASK_STACK_BYTES // max(1, _BYTES_PER_MASK_PIXEL * (d_cap + g_cap) * pixels))
            for start in range(0, len(members), piece):
                rows = members[start:start + piece]
                det_slots, gt_slots = [], []
                crowd = np.zeros((len(rows), g_cap), bool)
                for k, row in enumerate(rows):
                    u = chunk[row]
                    det_slots += [("det", u["img"], j) for j in u["didx"]] + [None] * (d_cap - len(u["didx"]))
                    gt_slots += [("gt", u["img"], j) for j in u["gidx"]] + [None] * (g_cap - len(u["gidx"]))
                    crowd[k, :len(u["gidx"])] = u["gt_crowd"]
                values, lengths = self._mask_runs(det_slots + gt_slots, pixels)
                begin = _recorded_event(self.device)
                dense = self._dense_masks(values, lengths, (len(det_slots) + len(gt_slots)) * pixels)
                dm = dense[:len(det_slots) * pixels].view(len(rows), d_cap, pixels)
                gm = dense[len(det_slots) * pixels:].view(len(rows), g_cap, pixels)
                ious[rows] = batched_mask_iou(dm, gm, torch.from_numpy(crowd).to(self.device),
                                              dtype=torch.float64 if small else torch.float32).to(torch.float32)
                if begin is not None:
                    self._piece_events.append((begin, _recorded_event(self.device)))
                stats["f64_iou_units" if small else "f32_iou_units"] += len(rows)
                stats["mask_pieces"] += 1
        return ious

    def _match_padded(self, padded: Tuple[np.ndarray, ...], iou_thrs: Tensor,
                      ious: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
        """(IoUs, matched, ignored) of one padded chunk, on the metric's device; the box IoUs unless ``ious``
        is given."""
        db, gb, det_valid, gt_valid, gt_crowd, gt_ignore, det_oor = (
            torch.from_numpy(a).to(self.device, non_blocking=True) for a in padded)
        if ious is None:
            # float64 host boxes become float32 on the device, as the JAX package hands them over without x64
            ious = batched_box_iou(db.to(torch.float32), gb.to(torch.float32), gt_crowd)
        dtm, dtig = match_units(ious, gt_valid, gt_crowd, gt_ignore, det_valid, det_oor, iou_thrs)
        return ious, dtm, dtig

    def _evaluate(self, i_type: str = "bbox", average: Optional[str] = None):
        micro = (average or self.average) == "micro"
        iou_thrs = np.asarray(self.iou_thresholds)
        rec_thrs = np.asarray(self.rec_thresholds)
        max_dets = self.max_detection_thresholds
        n_imgs = len(self.detection_box)
        classes = sorted(
            set(np.concatenate([np.asarray(lbl).reshape(-1) for lbl in self.gt_label]).tolist())
            | set(np.concatenate([np.asarray(lbl).reshape(-1) for lbl in self.detection_label]).tolist())
        ) if n_imgs else []
        area_names = list(_BBOX_AREA_RANGES)
        t_n, r_n, a_n, m_n = len(iou_thrs), len(rec_thrs), len(area_names), len(max_dets)
        k_n = 1 if micro else len(classes)
        precision = -np.ones((t_n, r_n, k_n, a_n, m_n))
        recall = -np.ones((t_n, k_n, a_n, m_n))
        scores_out = -np.ones((t_n, r_n, k_n, a_n, m_n))
        if not n_imgs or not classes:
            return precision, recall, scores_out, classes, {}
        t0 = time.perf_counter()
        self._start_evaluation()
        units = self._build_units(i_type, micro, classes)
        if not units:
            return precision, recall, scores_out, classes, {}

        # match in chunks of units of similar size, so that one dense image does not pad every unit
        ranges = np.asarray([_BBOX_AREA_RANGES[a] for a in area_names])
        thr_d = torch.from_numpy(iou_thrs).to(self.device, torch.float32)
        order_by_size = sorted(range(len(units)), key=lambda i: (len(units[i]["didx"]), len(units[i]["gidx"])))
        size = _CHUNK_UNITS[i_type]
        chunks = [order_by_size[s:s + size] for s in range(0, len(order_by_size), size)]
        t1 = time.perf_counter()
        padded = [self._pad_chunk([units[i] for i in sel], ranges) for sel in chunks]
        t2 = time.perf_counter()
        chunk_ious = [None] * len(chunks)
        if i_type == "segm":
            chunk_ious = [self._segm_ious([units[i] for i in sel], chunk[2].shape[1], chunk[3].shape[1])
                          for sel, chunk in zip(chunks, padded)]
        t_iou = time.perf_counter()
        begin = _recorded_event(self.device)
        on_device = [self._match_padded(chunk, thr_d, ious) for chunk, ious in zip(padded, chunk_ious)]
        end = _recorded_event(self.device)
        fetched = [tuple(x.cpu().numpy() for x in result) for result in on_device]
        t3 = time.perf_counter()
        unit_dtm: List[Any] = [None] * len(units)
        unit_dtig: List[Any] = [None] * len(units)
        unit_gtig: List[Any] = [None] * len(units)
        unit_ious: List[Any] = [None] * len(units)
        for sel, (ious, dtm, dtig), chunk in zip(chunks, fetched, padded):
            gt_ignore = chunk[5]
            for row, i in enumerate(sel):
                nd, ng = len(units[i]["didx"]), len(units[i]["gidx"])
                unit_dtm[i] = dtm[row, :, :, :nd]
                unit_dtig[i] = dtig[row, :, :, :nd]
                unit_gtig[i] = gt_ignore[row, :, :ng]
                unit_ious[i] = ious[row, :nd, :ng]

        # host accumulation: a stable sort of the scores, cumulative sums, 101-point interpolation
        ious_dict = {(u["img"], (classes[u["ki"]] if not micro else -1)): unit_ious[i] for i, u in enumerate(units)}
        unit_ki = np.asarray([u["ki"] for u in units])
        unit_npig = np.stack([(~g).sum(axis=1) for g in unit_gtig])  # (U, A) non-ignored ground truths
        for ki in range(k_n):
            sel = np.nonzero(unit_ki == ki)[0]
            if not len(sel):
                continue
            npig_per_area = unit_npig[sel].sum(axis=0)
            for mi, max_det in enumerate(max_dets):
                scores_cat = np.concatenate([units[i]["scores"][:max_det] for i in sel])
                order = np.argsort(-scores_cat, kind="mergesort")
                tps = np.concatenate([unit_dtm[i][:, :, :max_det] for i in sel], axis=2)[:, :, order]  # (A, T, N)
                igs = np.concatenate([unit_dtig[i][:, :, :max_det] for i in sel], axis=2)[:, :, order]
                scores_sorted = scores_cat[order]
                tp_c = np.cumsum(tps & ~igs, axis=2, dtype=np.float64)
                fp_c = np.cumsum(~tps & ~igs, axis=2, dtype=np.float64)
                n = tp_c.shape[2]
                if n == 0:
                    for ai in np.nonzero(npig_per_area)[0]:
                        recall[:, ki, ai, mi] = 0.0
                        precision[:, :, ki, ai, mi] = 0.0
                        scores_out[:, :, ki, ai, mi] = 0.0
                    continue
                live = npig_per_area > 0
                npig_safe = np.maximum(npig_per_area, 1).astype(np.float64)
                rc = tp_c / npig_safe[:, None, None]
                pr = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
                recall[:, ki, live, mi] = rc[live, :, -1].T
                pr = np.maximum.accumulate(pr[:, :, ::-1], axis=2)[:, :, ::-1]
                inds = np.empty((a_n, t_n, r_n), dtype=np.int64)
                for ai in range(a_n):
                    for ti in range(t_n):
                        inds[ai, ti] = np.searchsorted(rc[ai, ti], rec_thrs, side="left")
                valid = inds < n
                inds_c = np.minimum(inds, n - 1)
                q = np.where(valid, np.take_along_axis(pr, inds_c.reshape(a_n, t_n, -1), axis=2), 0.0)
                s = np.where(valid, scores_sorted[inds_c], 0.0)
                precision[:, :, ki, live, mi] = q[live].transpose(1, 2, 0)
                scores_out[:, :, ki, live, mi] = s[live].transpose(1, 2, 0)
        stages = {"units": len(units), "chunks": len(chunks), "build_units_s": t1 - t0, "pad_s": t2 - t1,
                  "match_and_fetch_s": t3 - t_iou, "accumulate_s": time.perf_counter() - t3,
                  "match_device_s": begin.elapsed_time(end) / 1000 if begin is not None else None}
        if i_type == "segm":
            # mask_iou_s is the host's wall time of the asynchronous launches; on the card, mask_iou_device_s sums
            # each piece's time from before its expansion to after its quotients (the fetch above waited for them)
            device_s = sum(b.elapsed_time(e) for b, e in self._piece_events) / 1000 if self._piece_events else None
            stages.update({"mask_iou_s": t_iou - t2, "mask_iou_device_s": device_s, **self._segm_stats})
        self.last_evaluation[i_type] = stages
        self._counts_cache = {}
        return precision, recall, scores_out, classes, ious_dict

    @staticmethod
    def _summarize(precision, recall, t_slice=None, area="all", max_det_idx=-1,
                   area_names=("all", "small", "medium", "large")) -> float:
        ai = area_names.index(area)
        if precision is not None:
            p = precision[:, :, :, ai, max_det_idx]
            if t_slice is not None:
                p = p[t_slice : t_slice + 1]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0
        r = recall[:, :, ai, max_det_idx]
        if t_slice is not None:
            r = r[t_slice : t_slice + 1]
        r = r[r > -1]
        return float(np.mean(r)) if r.size else -1.0

    def compute(self) -> Dict[str, Any]:
        """Run COCO's evaluation and return its summary, float32 tensors on the metric's device."""
        md_idx = len(self.max_detection_thresholds) - 1
        iou_thrs = np.asarray(self.iou_thresholds)

        def t_idx(v):
            hits = np.where(np.isclose(iou_thrs, v))[0]
            return int(hits[0]) if len(hits) else None

        def tensor(v: Any, dtype: torch.dtype = torch.float32) -> Tensor:
            return torch.as_tensor(np.asarray(v), dtype=dtype).to(self.device)

        res: Dict[str, Any] = {}
        classes: List[int] = []
        for i_type in self.iou_type:
            prefix = "" if len(self.iou_type) == 1 else f"{i_type}_"
            precision, recall, scores, classes, ious_dict = self._evaluate(i_type)
            res[f"{prefix}map"] = self._summarize(precision, None, None, "all", md_idx)
            i50, i75 = t_idx(0.5), t_idx(0.75)
            res[f"{prefix}map_50"] = self._summarize(precision, None, i50, "all", md_idx) if i50 is not None else -1.0
            res[f"{prefix}map_75"] = self._summarize(precision, None, i75, "all", md_idx) if i75 is not None else -1.0
            for aname in ("small", "medium", "large"):
                res[f"{prefix}map_{aname}"] = self._summarize(precision, None, None, aname, md_idx)
                res[f"{prefix}mar_{aname}"] = self._summarize(None, recall, None, aname, md_idx)
            for mi, md in enumerate(self.max_detection_thresholds):
                res[f"{prefix}mar_{md}"] = self._summarize(None, recall, None, "all", mi)
            if self.class_metrics and len(classes):
                if self.average == "micro":
                    # micro pools every class into one; the per-class numbers need a macro pass
                    cls_precision, cls_recall, _, _, _ = self._evaluate(i_type, average="macro")
                else:
                    cls_precision, cls_recall = precision, recall
                map_per_class, mar_per_class = [], []
                for ki in range(len(classes)):
                    p = cls_precision[:, :, ki, 0, md_idx]
                    p = p[p > -1]
                    map_per_class.append(float(np.mean(p)) if p.size else -1.0)
                    r = cls_recall[:, ki, 0, md_idx]
                    r = r[r > -1]
                    mar_per_class.append(float(np.mean(r)) if r.size else -1.0)
                res[f"{prefix}map_per_class"] = tensor(map_per_class)
                res[f"{prefix}mar_{self.max_detection_thresholds[-1]}_per_class"] = tensor(mar_per_class)
            if self.extended_summary:
                res[f"{prefix}ious"] = {k: tensor(v) for k, v in ious_dict.items()}
                res[f"{prefix}precision"] = tensor(precision)
                res[f"{prefix}recall"] = tensor(recall)
                res[f"{prefix}scores"] = tensor(scores)
        res["classes"] = tensor(classes, torch.int32)
        return {k: v if isinstance(v, (torch.Tensor, dict)) else tensor(v) for k, v in res.items()}
