"""The backward passes of a step (stage "backward"), ms a step."""


def read(r):
    return r.per_unit("backward")
