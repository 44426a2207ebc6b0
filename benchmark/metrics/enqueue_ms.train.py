"""The host's own work in the step, ms an optimizer step: the
`entry.*_train_step` spans of the profiled stretch less the `sync.*` spans
inside them."""

from benchmark import spans


def read(r):
    return spans.enqueue_ms(r)
