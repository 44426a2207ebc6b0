"""The whole work's share of the card's peak, %: the model FLOPs of the
traced window's completed shapes (benchmark.counts), all at the 989 TFLOP/s
bf16 peak, over the window's wall time."""


def read(r):
    return r.mfu()
