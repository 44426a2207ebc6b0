"""Clustering (stage "mean_shift": the bandwidth, every K1 attempt and its
NMS), ms a shape."""


def read(r):
    return r.per_unit("mean_shift")
