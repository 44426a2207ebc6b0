"""The embedding losses of a training step (stage "embed_losses": the
triplet and type losses of every micro-batch), ms a step."""


def read(r):
    return r.per_unit("embed_losses")
