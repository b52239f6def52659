"""%: 1 - (the union of the card's kernel, copy and memset intervals / the traced passes' span); the mean
of the ranks in a world of ranks."""

from benchlib.readers import idle_pct

NEEDS = ("profile",)


def measure(view):
    return idle_pct(view)
