"""The host's own work in the entry, ms a shape: the `entry.*` spans of
the profiled stretch less the `sync.*` spans inside them."""

from benchmark import spans


def read(r):
    return spans.enqueue_ms(r)
