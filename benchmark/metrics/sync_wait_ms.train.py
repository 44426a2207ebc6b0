"""The host's wait in its synchronisations, ms an optimizer step: the
summed durations of the program's `sync.*` spans in the profiled stretch
over its `entry.*_train_step` spans."""

from benchmark import spans


def read(r):
    return spans.sync_wait_ms(r)
