"""The step's wait for its batch, ms an optimizer step: the outermost
`feed.*` spans of the profiled stretch (the trainer taking the next batch
from its feed) over its `entry.*_train_step` spans."""

from benchmark import spans


def read(r):
    feeds, u = spans.outermost(spans.named(r, "feed.")), spans.units(r)
    if not feeds or not u:
        return None
    return sum(b - a for a, b in feeds) / 1e3 / u
