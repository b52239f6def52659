"""s: the host seconds of the binned-counts library's (B1's) first launch in the rank's process, as the
program keeps it (``metrics_tpu_torch.ops._native.first_launch_s``): its wrapper's launch call from after the
library loads to the launch function's return, in the warm-up pass, so inside ``setup_s``."""

NEEDS = ()


def measure(view):
    try:
        from metrics_tpu_torch.ops import _native
    except ImportError:
        return None
    return getattr(_native, "first_launch_s", {}).get("binned_hist")
