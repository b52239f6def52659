"""ms: device time of the kernels launched inside the program's ``compute:BinaryCalibrationError`` ranges,
less those inside its ``sync:*`` ranges (the exchange between ranks, the sync layer's), per traced pass."""

from benchlib.spans import device_ms_inside

NEEDS = ("profile",)
RANGES = ("compute:BinaryCalibrationError",)


def measure(view):
    if view.trace is None or not view.record["traced_passes"]:
        return None
    ms = device_ms_inside(view.trace, RANGES)
    return ms / view.record["traced_passes"] if ms else None
