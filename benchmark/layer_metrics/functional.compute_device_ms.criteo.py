"""ms: device time of the kernels launched inside the benchmark's ``compute()`` range, per traced pass.

The exchange between ranks is the sync layer's (``sync.gather_ms.ddp4``): kernels whose names start with
those below are left out, so that the number means the functional layer's compute on one card or on four.
"""

from benchlib.trace import total_us

NEEDS = ("profile",)
SYNC_KERNEL_PREFIXES = ("nccl",)


def measure(view):
    if view.trace is None or not view.record["traced_passes"]:
        return None
    kernels = [k for k in view.trace.kernels_inside("bench.compute")
               if not k.get("name", "").startswith(SYNC_KERNEL_PREFIXES)]
    return total_us(kernels) / 1e3 / view.record["traced_passes"] if kernels else None
