"""The least time a kernel's work can take on the card, from the shapes of the work alone.

Bytes are counted as the port's kernel table counts them: every input read once and every output
written once, whatever the kernel reads again. The count depends on the work, not on the code that
does it, so a later kernel that does the same work is held to the same bound.
"""

from __future__ import annotations

from typing import List, Tuple

# NVIDIA's data sheet for the H100 SXM (80 GB HBM3): bytes a second of device memory
PEAK_BYTES_PER_S = 3.35e12


def binned_confusion_bytes(rows: int, thresholds: int, score_bytes: int = 4) -> int:
    """One binary binned-confusion call: ``rows`` scores, 0/1 targets (int32) and a validity mask (bool)
    read; the (T, 2, 2) int32 counts written."""
    return rows * (score_bytes + 4 + 1) + thresholds * 2 * 2 * 4


def windowed_sum_bytes(planes: int, h_in: int, w_in: int, taps_h: int, taps_w: int) -> int:
    """One separable windowed-sum call over float32 planes: the padded planes read, the VALID sums written."""
    return planes * (h_in * w_in + (h_in - taps_h + 1) * (w_in - taps_w + 1)) * 4


def ssim_window_calls(batch: int, channels: int, height: int, width: int, kernel: int,
                      scales: int) -> List[Tuple[int, int, int]]:
    """(planes, padded height, padded width) of each windowed sum that SSIM (one scale) or MS-SSIM (each
    scale a 2x average pool of the last, odd edges dropped) needs for one batch: the five moment planes
    (x, y, x², y², xy) of every image and channel, reflect-padded by half the window."""
    calls = []
    h, w = height, width
    for i in range(scales):
        if i:
            h, w = h // 2, w // 2
        calls.append((5 * batch * channels, h + kernel - 1, w + kernel - 1))
    return calls


def least_seconds(nbytes: float) -> float:
    return nbytes / PEAK_BYTES_PER_S
