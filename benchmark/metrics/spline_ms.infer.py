"""The spline slots (stages "spline_preprocess" and "spline_decode": the
preprocessing, both SplineNets, the B-spline sampling and the placement),
ms a shape."""


def read(r):
    return r.per_unit("spline_preprocess", "spline_decode")
