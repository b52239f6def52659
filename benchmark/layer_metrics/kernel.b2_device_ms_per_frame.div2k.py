"""ms/frame: device time of the kernels launched inside the program's ``kernel:ssim_window`` ranges (the
windowed-sum wrapper, B2, whatever its kernel is named), per frame of the traced passes."""

from benchlib.spans import device_ms_inside

NEEDS = ("profile",)
RANGES = ("kernel:ssim_window",)


def measure(view):
    if view.trace is None or not view.record["traced_passes"]:
        return None
    ms = device_ms_inside(view.trace, RANGES)
    frames = view.record["traced_passes"] * sum(view.record["update_units"])
    return ms / frames if ms else None
