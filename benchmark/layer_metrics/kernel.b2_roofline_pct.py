"""%: the least time the traced windowed sums' work can take at 3.35 TB/s, from their shapes, over the
device time of the windowed-sum kernel (B2) in the trace.

Each update of B frames needs one windowed sum for SSIM and one per scale for MS-SSIM, each over the
five moment planes of every frame and channel (``benchlib.roofline.ssim_window_calls``). The kernel is
found by the names below until the port opens a profiler range around its wrapper.
"""

from benchlib.roofline import least_seconds, ssim_window_calls, windowed_sum_bytes
from benchlib.trace import named, total_us

NEEDS = ("profile",)
B2_KERNELS = ("ssim_window_kernel",)


def measure(view):
    if view.trace is None or not view.record["traced_passes"]:
        return None
    kernels = named(view.trace.kernels, B2_KERNELS)
    if not kernels:
        return None
    cfg = view.cell.config
    k = cfg["gaussian_kernel"]
    nbytes = 0
    for batch in view.record["update_units"]:
        for scales in (1, len(cfg["ms_ssim_betas"])):
            for planes, h, w in ssim_window_calls(batch, cfg["channels"], cfg["height"], cfg["width"], k, scales):
                nbytes += windowed_sum_bytes(planes, h, w, k, k)
    nbytes *= view.record["traced_passes"]
    return 100.0 * least_seconds(nbytes) / (total_us(kernels) * 1e-6)
