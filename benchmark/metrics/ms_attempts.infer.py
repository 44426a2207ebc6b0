"""Mean-shift bandwidths tried a shape: the `ms.attempt` spans of the
profiled stretch over its shapes (at least 1; the share of the attempts
that is the accepted one is 1 over it)."""

from benchmark import spans


def read(r):
    return spans.ms_attempts(r)
