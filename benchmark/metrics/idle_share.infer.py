"""The device's idle share, %: 1 - the union of the device operations'
intervals in the profiler's trace over the profiled stretch's wall time."""


def read(r):
    return r.idle_share()
