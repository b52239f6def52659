"""ms: host time of the benchmark's span around ``MetricCollection.update()`` (no sync), mean over the
window's untraced passes."""

from benchlib.readers import mean_update_host_ms


def measure(view):
    return mean_update_host_ms(view)
