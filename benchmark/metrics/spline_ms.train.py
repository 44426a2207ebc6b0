"""The frozen SplineNets of a training step (stage "spline"), ms a step."""


def read(r):
    return r.per_unit("spline")
