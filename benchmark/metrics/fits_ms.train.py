"""The fits of a training step (stage "fits"), ms a step."""


def read(r):
    return r.per_unit("fits")
