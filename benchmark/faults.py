"""Faults planted after the network, in half of each request's shapes: what
the check has to catch that the network's outputs cannot show. Each is a
context manager that changes the program's inference pipeline while it is
open; the tests and benchmark/readings.py use them, benchmark/run.py never.

The pipeline handles a request's shapes one after another, so a count of
the calls tells a shape's place in its request: the second half of each
request (places batch // 2 onwards) gets the fault.
"""
from __future__ import annotations

import contextlib

import torch


def _second_half(batch: int):
    calls = [0]

    def hit() -> bool:
        place = calls[0] % batch
        calls[0] += 1
        return place >= batch // 2
    return hit


@contextlib.contextmanager
def _patched(module, name: str, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _pipeline():
    from parsenet_tpu_torch.eval import pipeline
    return pipeline


def half_clusters(batch: int):
    """Mean-shift's labels of the second half altered where they are made:
    clusters 2j and 2j + 1 merged."""
    hit = _second_half(batch)

    def make(guard_mean_shift):
        def altered(*args, **kwargs):
            ms = guard_mean_shift(*args, **kwargs)
            if not hit():
                return ms
            lab = ms.labels
            return ms._replace(labels=lab - (lab % 2))
        return altered
    return _patched(_pipeline(), "guard_mean_shift", make)


@contextlib.contextmanager
def half_unshifted(batch: int):
    """Mean-shift's iterations of the second half return their state
    unchanged: every attempt clusters the embedding as it came."""
    from parsenet_tpu_torch.ops import mean_shift
    hit = _second_half(batch)
    on = [False]

    def make_guard(guard_mean_shift):
        def marked(*args, **kwargs):
            on[0] = hit()
            try:
                return guard_mean_shift(*args, **kwargs)
            finally:
                on[0] = False
        return marked

    def make_shift(shift):
        def unchanged(X, *args, **kwargs):
            return X if on[0] else shift(X, *args, **kwargs)
        return unchanged

    with _patched(_pipeline(), "guard_mean_shift", make_guard), \
            _patched(mean_shift, "_shift", make_shift):
        yield


def _shifted(x, by: float):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x + by
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_shifted(v, by) for v in x))
    return x


def half_fits(batch: int, by: float = 0.1):
    """The fitted primitives of the second half altered where they are
    made: every parameter (offsets, centres, radii, axes, angles) moved by
    `by`."""
    hit = _second_half(batch)

    def make(fit_and_sample):
        def altered(*args, **kwargs):
            params, *rest = fit_and_sample(*args, **kwargs)
            return (_shifted(params, by) if hit() else params, *rest)
        return altered
    return _patched(_pipeline(), "_fit_and_sample", make)


# by driver: the faults that its entry's pipeline can have
AFTER_NETWORK = {"batch_metrics": (half_clusters, half_unshifted, half_fits),
                 "predict_segmentation": (half_clusters, half_unshifted)}
