"""The network (stage "dgcnn": the DGCNN forward with its kNN graphs, the
type argmax, the embedding normalised), ms a shape."""


def read(r):
    return r.per_unit("dgcnn")
