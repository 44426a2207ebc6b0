"""Host synchronisations a shape: the program's `sync.*` spans in the
profiled stretch over its shapes."""

from benchmark import spans


def read(r):
    return spans.host_syncs(r)
