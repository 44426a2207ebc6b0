"""Host-side lookahead and host-to-device prefetching.

Counterpart of parsenet_tpu/data/prefetch.py. `lookahead` runs a batch
generator in a background thread behind a bounded queue, so batch
preparation overlaps the device's steps; the trainers wrap their training
generator in it. `prefetch_to_device` also copies each batch to the card
ahead of use: pinned host memory and non_blocking copies on a side CUDA
stream, an event the consumer's stream waits on before it reads the
batch, and `record_stream` on every tensor so the caching allocator does
not hand its memory to another stream while the consumer still reads it.
With device="cpu" a batch is a plain `torch.as_tensor` of each array.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..core.guards import entry_device


def _background(it: Iterator, size: int, work=lambda b: b) -> Iterator:
    """work(batch) of every batch of `it`, computed in a daemon thread at
    most `size` batches ahead, in order; ends where `it` ends. An exception
    in the producer is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    failure = []

    def producer():
        try:
            for batch in it:
                q.put(work(batch))
        except BaseException as e:   # handed to the consumer below
            failure.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if failure:
                raise failure[0]
            return
        yield item


def lookahead(it: Iterator, size: int = 2) -> Iterator:
    """The batches of `it`, produced by a background thread up to `size`
    ahead of the consumer (parsenet_tpu/data/prefetch.py:48-66)."""
    return _background(it, size)


def _tree_map(fn, batch):
    if isinstance(batch, (tuple, list)):
        items = [_tree_map(fn, b) for b in batch]
        return type(batch)(*items) if hasattr(batch, "_fields") \
            else type(batch)(items)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return None if batch is None else fn(batch)


def prefetch_to_device(it: Iterator, size: int = 2, device=None) -> Iterator:
    """The batches of `it` (numpy arrays or tensors, in tuples, lists or
    dicts; None stays None) as tensors on `device` (None = "cuda"),
    copied up to `size` batches ahead of the consumer.

    On the card a background thread pins each array and issues its copy
    with non_blocking=True on a side stream, then records an event; the
    consumer's current stream waits on that event when the batch is
    yielded, and each tensor is marked as used by that stream
    (record_stream), so a batch is never read before its copy lands and
    its memory is not reused while the consumer reads it."""
    dev = entry_device(device)
    if dev.type != "cuda":
        return _background(it, size, lambda b: _tree_map(
            lambda a: torch.as_tensor(a, device=dev), b))
    side = torch.cuda.Stream(device=dev)

    def copy(batch):
        def one(a):
            host = torch.as_tensor(np.ascontiguousarray(a)
                                   if isinstance(a, np.ndarray) else a)
            if host.device.type == "cpu":
                host = host.pin_memory()
            return host.to(dev, non_blocking=True)
        with torch.cuda.stream(side):
            out = _tree_map(one, batch)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def consume():
        for out, done in _background(it, size, copy):
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(done)
            _tree_map(lambda t: t.record_stream(stream), out)
            yield out

    return consume()
