"""The slots' chamfer of the fitting loss (stage "chamfer", K3 forward; K4
runs in the backward), ms a step."""


def read(r):
    return r.per_unit("chamfer")
