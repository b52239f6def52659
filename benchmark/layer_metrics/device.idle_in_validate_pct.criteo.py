"""%: the share of the traced passes in which no kernel, copy or memset ran on the rank's device while the
program's ``validate:*`` ranges were open (its input validations, which read the card on the host); the
mean of the ranks in a world of ranks. The idle time is ``device.idle_pct.criteo``'s, restricted to those
ranges."""

from benchlib.spans import intervals, overlap_us, ranges_with_prefix
from benchlib.trace import busy_idle

NEEDS = ("profile",)


def measure(view):
    if view.trace is None or not view.record["traced_passes"]:
        return None
    validations = ranges_with_prefix(view.trace, "validate:")
    if not validations:
        return None
    lo, hi = view.trace.window()
    _, gaps = busy_idle(view.trace.device_ops, lo, hi)
    return 100.0 * overlap_us(gaps, intervals(validations, lo, hi)) / (hi - lo)
