"""The residual and the coverage (stages "spline_residual", "residual" and
"coverage", K3), ms a shape."""


def read(r):
    return r.per_unit("spline_residual", "residual", "coverage")
