"""Matching in a training step (stage "matching": the K2 LAP, the membership
weights, the SIOU metric), ms a step."""


def read(r):
    return r.per_unit("matching")
