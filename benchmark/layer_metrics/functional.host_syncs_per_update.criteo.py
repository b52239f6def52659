"""syncs/update: host synchronizations per ``update()``, counted under CUDA's sync debug mode over one
pass before the window; an exact count."""

NEEDS = ("sync_debug",)


def measure(view):
    return view.record.get("syncs_per_update")


def combine(values):
    return max(values)
