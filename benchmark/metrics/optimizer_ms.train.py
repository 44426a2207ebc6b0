"""The gradient average, guard and Adam step (stage "optimizer"), ms a step."""


def read(r):
    return r.per_unit("optimizer")
