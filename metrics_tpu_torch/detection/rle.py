"""COCO run-length-encoded (RLE) binary masks (counterpart of ``metrics_tpu/detection/rle.py``).

An RLE object is ``{"size": [h, w], "counts": bytes | list[int]}``: the run
lengths of the column-major mask, alternating background and foreground and
starting with a (possibly empty) background run; ``bytes`` is COCO's compressed
string form, ``list`` the plain run lengths. The bytes are those of the JAX
package and of pycocotools.

The work is split by where it is cheap:

* the run lengths of a batch of masks are found on the masks' own device
  (:func:`masks_to_runs`: a column-major flatten, one comparison of
  neighbours, one ``nonzero``), so masks on the card never travel to the host;
* the byte-level loops (compressing and decompressing the counts string,
  expanding runs into a plane) run in the host C++ codec
  ``csrc/rle_codec.cpp``, built at first use by :mod:`metrics_tpu_torch.ops._native`.
  A failed build raises;
* ``_compress_counts_plain``, ``_decompress_counts_plain`` and
  ``_expand_plain`` are the codec's plain Python versions. The tests hold
  the codec against them; nothing else calls them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.ops import _native

__all__ = [
    "mask_to_rle",
    "rle_to_mask",
    "rle_area",
    "rle_iou",
    "compress_counts",
    "decompress_counts",
]

RLE = Dict[str, Union[bytes, List[int], Sequence[int]]]

_LL = ctypes.c_longlong
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_LLP = ctypes.POINTER(_LL)


def _codec() -> ctypes.CDLL:
    lib = _native.load("rle_codec")
    if lib.rle_compress_counts.restype is not _LL:
        lib.rle_compress_counts.restype = _LL
        lib.rle_compress_counts.argtypes = [_LLP, _LL, _U8P]
        lib.rle_decompress_counts.restype = _LL
        lib.rle_decompress_counts.argtypes = [_U8P, _LL, _LLP]
        lib.rle_expand.restype = ctypes.c_int
        lib.rle_expand.argtypes = [_LLP, _LL, _LL, _U8P]
    return lib


# ----------------------------------------------------------------------------- run lengths on the device
def masks_to_runs(masks: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Column-major run lengths of every mask of an ``(N, h, w)`` batch, found on the batch's device.

    Returns ``(runs, offsets)`` on the host: mask ``i``'s runs are ``runs[offsets[i]:offsets[i + 1]]``, the
    first counting background (0 when the first pixel is set). Values are read as ``uint8``, as
    ``numpy.asarray(mask, dtype=numpy.uint8)`` reads them.
    """
    n, h, w = masks.shape
    hw = h * w
    if n == 0 or hw == 0:
        return np.zeros(0, np.int64), np.zeros(n + 1, np.int64)
    flat = masks.to(torch.uint8).transpose(1, 2).reshape(n, hw)
    rows, cols = (flat[:, 1:] != flat[:, :-1]).nonzero(as_tuple=True)
    pos = cols + 1  # where each new run starts
    lead = (flat[:, 0] == 1).long()  # the counts start with an empty background run
    k = torch.bincount(rows, minlength=n)
    starts = torch.cumsum(k, 0) - k  # index of each mask's first boundary in `pos`
    length = k + 1 + lead
    offsets = torch.cumsum(length, 0) - length
    runs = torch.zeros(int(length.sum()), dtype=torch.int64, device=masks.device)
    # the run ending at each boundary: from the previous boundary of the same mask, or from the mask's start
    first = torch.ones_like(pos, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    prev = torch.where(first, torch.zeros_like(pos), torch.roll(pos, 1))
    slot = offsets[rows] + lead[rows] + (torch.arange(len(pos), device=masks.device) - starts[rows])
    runs[slot] = pos - prev
    last = torch.zeros(n, dtype=torch.int64, device=masks.device)
    has = k > 0
    last[has] = pos[starts[has] + k[has] - 1]
    runs[offsets + lead + k] = hw - last
    out_offsets = torch.cat([offsets, offsets[-1:] + length[-1:]])
    return runs.cpu().numpy(), out_offsets.cpu().numpy()


# ----------------------------------------------------------------------------- the codec
def compress_counts(counts: Sequence[int]) -> bytes:
    """Encode run lengths into COCO's compressed string form, in the C++ codec.

    Each value (from the fourth on, the difference from the value two before) is written as little-endian
    5-bit groups with a continuation bit, offset by 48 into printable ASCII.
    """
    arr = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty(max(13 * len(arr), 16), dtype=np.uint8)  # an int64 spans at most 13 five-bit groups
    n = _codec().rle_compress_counts(arr.ctypes.data_as(_LLP), len(arr), out.ctypes.data_as(_U8P))
    return out[:n].tobytes()


def decompress_counts(data: Union[bytes, str]) -> np.ndarray:
    """Decode COCO's compressed string form back into run lengths, in the C++ codec."""
    if isinstance(data, str):
        data = data.encode("ascii")
    if data and ((data[-1] - 48) & 0x20):
        raise ValueError("truncated RLE counts string: final byte has the continuation bit set")
    if not data:
        return np.zeros(0, dtype=np.int64)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(len(buf), dtype=np.int64)
    n = _codec().rle_decompress_counts(buf.ctypes.data_as(_U8P), len(buf), out.ctypes.data_as(_LLP))
    if n < 0:
        raise ValueError("malformed RLE counts string: value wider than 13 5-bit groups")
    return out[:n].copy()


def _compress_counts_plain(counts: Sequence[int]) -> bytes:
    """The plain Python version of :func:`compress_counts`."""
    out = bytearray()
    counts = [int(c) for c in counts]
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        more = True
        while more:
            bits = x & 0x1F
            x >>= 5
            # stop when the bits left are the sign's extension
            more = not (x == 0 and not (bits & 0x10)) and not (x == -1 and (bits & 0x10))
            if more:
                bits |= 0x20
            out.append(bits + 48)
    return bytes(out)


def _decompress_counts_plain(data: Union[bytes, str]) -> np.ndarray:
    """The plain Python version of :func:`decompress_counts`, with the codec's int64 wraparound."""
    if isinstance(data, str):
        data = data.encode("ascii")
    if data and ((data[-1] - 48) & 0x20):
        raise ValueError("truncated RLE counts string: final byte has the continuation bit set")
    counts: List[int] = []
    pos = 0
    while pos < len(data):
        x = 0
        k = 0
        more = True
        while more:
            if k >= 13:
                raise ValueError("malformed RLE counts string: value wider than 13 5-bit groups")
            byte = data[pos] - 48
            if 5 * k < 64:
                x |= (byte & 0x1F) << (5 * k)
            more = bool(byte & 0x20)
            pos += 1
            k += 1
            if not more and (byte & 0x10) and 5 * k < 64:
                x |= -1 << (5 * k)  # sign-extend
        x &= (1 << 64) - 1
        if x >= 1 << 63:
            x -= 1 << 64
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, dtype=np.int64)


def _expand(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """The ``(h, w)`` uint8 mask of run lengths, expanded in the C++ codec."""
    c = np.ascontiguousarray(counts, dtype=np.int64)
    flat = np.empty(h * w, dtype=np.uint8)
    rc = _codec().rle_expand(c.ctypes.data_as(_LLP), len(c), h * w, flat.ctypes.data_as(_U8P))
    if rc != 0:
        raise ValueError(f"RLE counts sum to {int(c.sum())}, expected {h * w}")
    return flat.reshape((w, h)).T  # column-major layout


def _expand_plain(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """The plain numpy version of :func:`_expand`."""
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size != h * w:
        raise ValueError(f"RLE counts sum to {flat.size}, expected {h * w}")
    return flat.reshape((w, h)).T


# ----------------------------------------------------------------------------- RLE objects
def masks_to_rles(masks: Union[torch.Tensor, np.ndarray], compress: bool = True) -> List[RLE]:
    """One RLE object per mask of an ``(N, h, w)`` batch, the run lengths found on the batch's device."""
    masks = masks if isinstance(masks, torch.Tensor) else torch.from_numpy(np.asarray(masks))
    if masks.ndim >= 1 and masks.shape[0] == 0:  # an image without masks, in any empty form (e.g. [])
        return []
    if masks.ndim != 3:
        raise ValueError(f"Expected a batch of 2d masks, got shape {tuple(masks.shape)}")
    size = [int(masks.shape[1]), int(masks.shape[2])]
    runs, offsets = masks_to_runs(masks)
    out = []
    for i in range(masks.shape[0]):
        r = runs[offsets[i]:offsets[i + 1]]
        out.append({"size": list(size), "counts": compress_counts(r) if compress else r.tolist()})
    return out


def mask_to_rle(mask: Union[torch.Tensor, np.ndarray], compress: bool = True) -> RLE:
    """Encode a binary mask ``(h, w)`` into an RLE object.

    >>> m = np.zeros((3, 3), dtype=np.uint8); m[1, 1] = 1
    >>> rle = mask_to_rle(m, compress=False)
    >>> rle["size"], list(rle["counts"])
    ([3, 3], [4, 1, 4])
    """
    mask = mask if isinstance(mask, torch.Tensor) else torch.from_numpy(np.asarray(mask))
    if mask.ndim != 2:
        raise ValueError(f"Expected a 2d mask, got shape {tuple(mask.shape)}")
    return masks_to_rles(mask[None], compress)[0]


def _counts_of(rle: RLE) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        return decompress_counts(counts)
    return np.asarray(counts, dtype=np.int64)


def rle_to_mask(rle: RLE) -> np.ndarray:
    """Decode an RLE object back into a ``(h, w)`` uint8 mask.

    >>> m = (np.arange(12).reshape(3, 4) % 3 == 0).astype(np.uint8)
    >>> bool((rle_to_mask(mask_to_rle(m)) == m).all())
    True
    """
    h, w = (int(s) for s in rle["size"])
    return _expand(_counts_of(rle), h, w)


def rle_area(rles: Union[RLE, Sequence[RLE]]) -> np.ndarray:
    """Foreground pixel count per RLE (the sum of the odd runs), as a 1-d float64 array."""
    if isinstance(rles, dict):
        rles = [rles]
    return np.asarray([int(_counts_of(r)[1::2].sum()) for r in rles], dtype=np.float64)


def rle_iou(dt: Sequence[RLE], gt: Sequence[RLE], iscrowd: Sequence[bool]) -> np.ndarray:
    """Pairwise mask IoU in float64 with COCO's crowd rule, on masks decoded on the host.

    ``MeanAveragePrecision`` takes this path for a group of fewer than four units of one mask size in a
    chunk, as the JAX package does; larger groups go through
    :func:`metrics_tpu_torch.functional.detection.map_matching.batched_mask_iou` on the metric's device.
    """
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    d = np.stack([rle_to_mask(r).reshape(-1) for r in dt]).astype(np.float64)
    g = np.stack([rle_to_mask(r).reshape(-1) for r in gt]).astype(np.float64)
    inter = d @ g.T
    d_area = d.sum(1)
    g_area = g.sum(1)
    union = d_area[:, None] + g_area[None, :] - inter
    crowd = np.asarray(iscrowd, dtype=bool)
    union = np.where(crowd[None, :], d_area[:, None], union)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(union > 0, inter / union, 0.0)
    return out
