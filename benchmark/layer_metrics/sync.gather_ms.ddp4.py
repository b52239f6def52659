"""ms: host time of the port's own ``gather_all`` span (its recorder, on in the traced run only), per pass
of the window, on the slowest rank."""

NEEDS = ("observe",)


def measure(view):
    snap = view.record.get("observe")
    timers = (snap or {}).get("timers", {}).get("gather_all")
    if not timers or not view.record["passes"]:
        return None
    return sum(t["total_s"] for t in timers.values()) / view.record["passes"] * 1e3


def combine(values):
    return max(values)
