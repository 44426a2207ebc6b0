"""Clustering in a training step (stage "mean_shift": K1 f32 attempts, the
accepted bandwidth re-run with autograd, NMS), ms a step."""


def read(r):
    return r.per_unit("mean_shift")
