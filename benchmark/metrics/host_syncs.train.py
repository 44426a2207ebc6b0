"""Host synchronisations an optimizer step: the program's `sync.*` spans
in the profiled stretch over its `entry.*_train_step` spans."""

from benchmark import spans


def read(r):
    return spans.host_syncs(r)
