"""The fits and surface samples (stage "fits_sampling"), ms a shape."""


def read(r):
    return r.per_unit("fits_sampling")
