"""The collectives' device time, ms an optimizer step: the NCCL kernels
(names holding "nccl") of rank 0's profiled stretch over its
`entry.*_train_step` spans. It holds the time rank 0's kernels spend
waiting for slower ranks. None where no NCCL kernel ran."""

from benchmark import spans


def read(r):
    ms = sum(b - a for name, a, b in r.kernels
             if "nccl" in name.lower()) / 1e3
    steps = spans.units(r)
    return ms / steps if ms > 0 and steps else None
