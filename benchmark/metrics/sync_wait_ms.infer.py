"""The host's wait in its synchronisations, ms a shape: the summed
durations of the program's `sync.*` spans in the profiled stretch."""

from benchmark import spans


def read(r):
    return spans.sync_wait_ms(r)
