"""The mean-shift kernels' share of their roofline, %: the least time of
the profiled stretch's mean-shift iterations (one accepted bandwidth's a
shape; benchmark.counts) over the device time of the K1 kernels
(ms_tc_kernel, ms_tf32_kernel, ms_exit_kernel) in the profiler's trace."""


def read(r):
    return r.mean_shift_roofline()
