"""ms/frame: device time of the kernels launched inside the benchmark's ``update()`` ranges that are not the
windowed-sum kernel's (B2), per frame of the traced passes."""

from benchlib.trace import total_us

NEEDS = ("profile",)
B2_KERNELS = ("ssim_window_kernel",)


def measure(view):
    if view.trace is None or not view.record["traced_passes"]:
        return None
    inside = view.trace.kernels_inside("bench.update")
    others = [k for k in inside if not any(n in k["name"] for n in B2_KERNELS)]
    frames = view.record["traced_passes"] * sum(view.record["update_units"])
    return total_us(others) / 1e3 / frames if others else None
