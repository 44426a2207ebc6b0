"""The whole work's share of the cards' peak, %: the model FLOPs of the
traced window's completed shapes (benchmark.counts; every rank's shapes,
the global batch) over the window's wall time, over the cell's cards x
the 989 TFLOP/s bf16 peak. None where the driver names no card count."""


def read(r):
    chips, mfu = r.unit_counts.get("chips"), r.mfu()
    return mfu / chips if chips and mfu is not None else None
