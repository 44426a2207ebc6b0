"""SIOU matching (stage "siou": one-hots, relaxed IoU, the K2 LAP of the
batch), ms a shape."""


def read(r):
    return r.per_unit("siou")
