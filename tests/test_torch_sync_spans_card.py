"""On the card: every host synchronisation that the port's five entry
points make in a request is one `sync.*` span.

One request of each entry (tests/torch_entries.py) at the benchmark's
sizes runs three times from the same start: first to build the kernels
and fill the caches, then under torch.cuda.set_sync_debug_mode("warn"),
where each torch call during which CUDA warned of a synchronisation
counts once (a call may wait more than once: CUDA's bincount reads its
input's minimum and maximum; and CUDA's warnings reach Python only as the
torch call returns), and last under torch.profiler, whose capture must
hold as many `sync.*` spans. A failure lists the operations
that synchronised, by the port's frames that called them. Imports no JAX:
on the card run

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_sync_spans_card.py
"""
from __future__ import annotations

import collections
import os
import sys
import traceback
import warnings

import pytest
import torch

import torch_entries as te

pytestmark = pytest.mark.card

SYNC_WARNING = "called a synchronizing CUDA operation"
# the benchmark's sizes: 10,000 points a test shape, 8,000 a training
# one, the largest bucket of a SplineNet step
POINTS = {"predict_segmentation": 10000, "batch_metrics": 10000,
          "seg_train_step": 8000, "e2e_train_step": 8000,
          "spline_train_step": 1984}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("counts the card's host synchronisations: needs a CUDA "
                    "card")
    from parsenet_tpu_torch.ops import kernels
    kernels.build_kernels()
    return torch.device("cuda", 0)


def _is_sync(w) -> bool:
    return SYNC_WARNING in str(w.message)


def _site() -> str:
    """The port's innermost three frames of the current stack."""
    frames = [f for f in traceback.extract_stack()
              if f"{os.sep}parsenet_tpu_torch{os.sep}" in f.filename]
    return " < ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                      for f in reversed(frames[-3:]))


class _SyncCalls:
    """A sys.setprofile hook: each call of a builtin (a torch function or
    method) during which sync warnings were recorded in `log` is one
    synchronising operation (the autograd engine's run_backward replays its
    operations' warnings at its end: one each), (name, caller's line); the
    warnings it raised leave `log`. Builtins the warnings module calls
    while it records are not operations."""

    def __init__(self, log: list):
        self.log, self.marks, self.ops = log, [], []

    def __call__(self, frame, event, arg):
        if event == "c_call":
            self.marks.append(len(self.log))
        elif event in ("c_return", "c_exception") and self.marks:
            before = self.marks.pop()
            if frame.f_globals.get("__name__") == "warnings":
                return
            new = [w for w in self.log[before:] if _is_sync(w)]
            if not new:
                return
            name = getattr(arg, "__name__", str(arg))
            site = (f"{os.path.basename(frame.f_code.co_filename)}:"
                    f"{frame.f_lineno} < {_site()}")
            self.ops += [(name, site)] * (len(new) if name == "run_backward"
                                          else 1)
            del self.log[before:]


def sync_ops(run) -> list:
    """The synchronising operations of one call of `run` (_SyncCalls), and
    a warning recorded outside any builtin's call as one more each."""
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        calls = _SyncCalls(log)
        torch.cuda.set_sync_debug_mode("warn")
        sys.setprofile(calls)
        try:
            run()
        finally:
            sys.setprofile(None)
            torch.cuda.set_sync_debug_mode(0)
    outside = [("outside a call", f"{os.path.basename(w.filename)}:"
                f"{w.lineno}") for w in log if _is_sync(w)]
    return calls.ops + outside


@pytest.mark.parametrize("entry", te.ENTRIES)
def test_every_host_sync_is_a_sync_span(card, entry):
    run = te.request(entry, card, POINTS[entry], 80)
    run()
    torch.cuda.synchronize()
    ops = sync_ops(run)
    torch.cuda.synchronize()
    spans = te.profiled(run)
    names = collections.Counter(n for n, _, _ in spans
                                if n.startswith("sync."))
    sites = collections.Counter(f"{op} at {site}" for op, site in ops)
    assert ops and len(ops) == sum(names.values()), (
        f"{entry}: {len(ops)} synchronising operations, "
        f"{sum(names.values())} sync spans {dict(names)}; operations: "
        + "; ".join(f"{k} x{v}" for k, v in sorted(sites.items())))
    assert sum(n == f"entry.{entry}" for n, _, _ in spans) == 1
