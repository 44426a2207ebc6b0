"""The SplineNet's forward in training mode (stage "forward": four kNN
graphs, the EdgeConvs with their batch moments, conv5, the pool and the
head), ms a step."""


def read(r):
    return r.per_unit("forward")
