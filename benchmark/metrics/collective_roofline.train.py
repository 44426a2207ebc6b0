"""The collectives' share of their roofline, %: a step's least all-reduce
time (benchmark.counts.dp: the step's f32 bytes, the flattened gradients
and the small reductions, times 2 (n - 1) / n over n ranks, at NVLink 4's
450 GB/s a direction) over collective_ms.train. None where that reads
nothing."""

from benchmark import harness
from benchmark.counts import dp


def read(r):
    ms = harness.load_module("metrics", "collective_ms.train").read(r)
    c = r.unit_counts
    if ms is None or "collective_bytes" not in c:
        return None
    least_ms = 1e3 * dp.allreduce_least_seconds(c["collective_bytes"],
                                                c["chips"])
    return 100.0 * least_ms / ms
