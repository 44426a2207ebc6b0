"""Mean-shift bandwidths tried a training shape: the `ms.attempt` spans of
the profiled stretch over its shapes (at least 1)."""

from benchmark import spans


def read(r):
    return spans.ms_attempts(r)
