"""The segmentation step's forwards with their losses (stage "forward": the
network, the triplet and type losses of every micro-batch), ms a step."""


def read(r):
    return r.per_unit("forward")
