"""The SplineNet's loss (stage "loss": the rescale, the 40 x 40 surface
samples, the one-sided chamfer on K3 and the min over the 80 symmetries of
a closed grid), ms a step."""


def read(r):
    return r.per_unit("loss")
