"""%: the least time the traced binned-confusion calls' work can take at 3.35 TB/s, from their shapes,
over the device time of the binned-counts kernel (B1) in the trace.

Each update makes one binary call over its rows at the mix's thresholds. The kernel is found by the
names below until the port opens a profiler range around its wrapper.
"""

from benchlib.roofline import binned_confusion_bytes, least_seconds
from benchlib.trace import named, total_us

NEEDS = ("profile",)
B1_KERNELS = ("binned_counts_kernel",)


def measure(view):
    thresholds = view.cell.mix["metric_options"].get("thresholds")
    if view.trace is None or not thresholds or not view.record["traced_passes"]:
        return None
    kernels = named(view.trace.kernels, B1_KERNELS)
    if not kernels:
        return None
    nbytes = view.record["traced_passes"] * sum(binned_confusion_bytes(n, thresholds)
                                                 for n in view.record["update_units"])
    return 100.0 * least_seconds(nbytes) / (total_us(kernels) * 1e-6)
