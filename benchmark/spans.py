"""The program's own spans in a traced run's profiler capture
(trace.Reading.ranges, host ranges on the profiler's clock): `entry.*`
around each request or optimizer step of an entry point, `sync.*` around
each host synchronisation it makes, `ms.attempt` around each mean-shift
bandwidth tried. The readers of host_syncs, sync_wait_ms, enqueue_ms and
ms_attempts; each gives None where the program opened none of the spans
it reads, as a program without them does."""
from __future__ import annotations

from typing import Optional


def named(r, prefix: str) -> list:
    """(start_us, end_us) of the ranges whose name starts with prefix."""
    return [(a, b) for n, a, b in r.ranges if n.startswith(prefix)]


def outermost(spans) -> list:
    """The spans that lie inside no other of `spans`."""
    out = []
    for a, b in sorted(spans, key=lambda s: (s[0], -s[1])):
        if not out or a >= out[-1][1]:
            out.append((a, b))
    return out


def units(r) -> Optional[int]:
    """Shapes of the profiled stretch (inference) or its optimizer steps,
    one an `entry.*_train_step` span (training); None where there are
    none."""
    if r.kind == "infer":
        return r.capture_units or None
    return len([1 for n, _, _ in r.ranges
                if n.startswith("entry.") and n.endswith("_train_step")]
               ) or None


def host_syncs(r) -> Optional[float]:
    """`sync.*` spans a shape or a step."""
    syncs, u = named(r, "sync."), units(r)
    return len(syncs) / u if syncs and u else None


def sync_wait_ms(r) -> Optional[float]:
    """ms of the outermost `sync.*` spans a shape or a step."""
    syncs, u = outermost(named(r, "sync.")), units(r)
    if not syncs or not u:
        return None
    return sum(b - a for a, b in syncs) / 1e3 / u


def enqueue_ms(r) -> Optional[float]:
    """ms of the host's own work a shape or a step: the outermost
    `entry.*` spans less the outermost `sync.*` spans inside them."""
    entries, u = outermost(named(r, "entry.")), units(r)
    if not entries or not u:
        return None
    inside = [(a, b) for a, b in outermost(named(r, "sync."))
              if any(ea <= a and b <= eb for ea, eb in entries)]
    return (sum(b - a for a, b in entries)
            - sum(b - a for a, b in inside)) / 1e3 / u


def ms_attempts(r) -> Optional[float]:
    """`ms.attempt` spans (mean-shift bandwidths tried) a shape of the
    profiled stretch; 1 where every shape's first bandwidth held."""
    n = len(named(r, "ms.attempt"))
    return n / r.capture_units if n and r.capture_units else None
