"""The network forward of a training step (stage "dgcnn_forward"), ms a
step."""


def read(r):
    return r.per_unit("dgcnn_forward")
