"""Start the ranks of one data-parallel run on this host.

`spawn(fn, world, args, device=..., deadline=...)` starts `world` processes
with the `spawn` start method (never fork: the parent may be a
multithreaded process), joins them in one process group over a FileStore
(a file under a fresh temporary directory unless `store_dir` names one; no
TCP port to collide with another run), sets one torch thread a rank where
the ranks share the CPU, and calls fn(mesh, *args) in each, `mesh` being
that rank's parallel.mesh.Mesh. It returns the ranks' results in rank
order. A rank that raises fails the call with its traceback; past
`deadline` seconds every rank is killed and the call raises TimeoutError,
so a run that hangs cannot outlive its caller's budget.

`lead(fn, world, args, device=..., deadline=...)` is the mode for a caller
that has to stay in charge of its own loop (a closed-loop client, an
interactive session): the calling process joins the group as rank 0 on
cuda:0 (or the CPU), and ranks 1..world-1 are spawned as above and call
fn(mesh, *args). It returns a `Followers` holding rank 0's mesh at once;
`Followers.join()` collects the other ranks' results in rank order and
raises a failed rank's traceback. Past `deadline` seconds from the start
every rank still running is killed and `join` raises TimeoutError. Each
spawned rank also exits as soon as the process that started it dies, so a
killed caller leaves no rank holding a card. `deadline` is the group's
collective timeout as well.

fn must be importable by name (a module-level function), and its
arguments and result picklable. On cards rank r takes cuda:r (NCCL); gloo
only with device="cpu".
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import wait
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def _exit_with_parent() -> None:
    """End this spawned rank as soon as the process that started it dies
    (the parent's end of the spawn pipe closes), whatever the rank is
    doing, a collective included."""
    parent = mp.parent_process()

    def watch():
        wait([parent.sentinel])
        os._exit(1)
    threading.Thread(target=watch, name="parent-watch", daemon=True).start()


def _rank_main(fn, rank: int, world: int, store_path: str, device: str,
               threads: Optional[int], args, results,
               led_timeout: Optional[float] = None, ready=None) -> None:
    """One spawned rank. led_timeout: set for the ranks of `lead`, which
    exit with their parent, take it as the group's timeout, put their rank
    on `ready` once started, before they join the group, and their result
    on `results` before they leave it: lead's caller leaves the group once
    it holds every result, and the ranks of an NCCL group leave it
    together (its communicator's teardown waits for every rank)."""
    from .mesh import make_mesh
    led = led_timeout is not None
    try:
        extra = {}
        if led:
            _exit_with_parent()
            extra["timeout"] = datetime.timedelta(seconds=led_timeout)
            ready.put(rank)
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
        store = dist.FileStore(store_path, world)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=store, rank=rank, world_size=world,
                                **extra)
        try:
            out = (True, fn(make_mesh(world, device=device), *args))
        except BaseException:
            out = (False, traceback.format_exc())
        if led:
            results.put((rank, *out))
        dist.destroy_process_group()
        if not led:
            results.put((rank, *out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def _check_cards(dev: torch.device, world: int, who: str) -> None:
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"{who}: {world} ranks asked for, but only "
                           f"{torch.cuda.device_count()} CUDA devices are "
                           "present")


def _store(store_dir: Optional[str]) -> tuple:
    """(the FileStore's path, the temporary directory made for it or
    None)."""
    own_dir = None
    if store_dir is None:
        own_dir = tempfile.mkdtemp(prefix="parsenet_store_")
        store_dir = own_dir
    path = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    return path, own_dir


def _start(ctx, fn, ranks, world: int, store_path: str, dev, threads, args,
           results, led_timeout=None, ready=None) -> list:
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store_path, str(dev), threads,
                               tuple(args), results, led_timeout, ready),
                         daemon=True)
             for r in ranks]
    for p in procs:
        p.start()
    return procs


def _await_start(procs: list, ranks: list, ready, end: float,
                 who: str) -> None:
    """Wait until every rank of `ranks` has started (put its rank on
    `ready`); a rank that exits first (its module or arguments failed to
    load in the new process) raises RuntimeError, and TimeoutError past
    `end`. The caller then joins the group without waiting on a rank that
    will never come."""
    started = set()
    while len(started) < len(ranks):
        if time.monotonic() > end:
            raise TimeoutError(f"{who} did not start in time")
        try:
            started.add(ready.get(timeout=0.5))
        except queue.Empty:
            dead = [(r, p.exitcode) for r, p in zip(ranks, procs)
                    if p.exitcode is not None and r not in started]
            if dead:
                raise RuntimeError(f"{who}: rank {dead[0][0]} exited with "
                                   f"code {dead[0][1]} before it started")


def _collect(procs: list, ranks: list, results, end: float, who: str,
             expired=lambda: False) -> dict:
    """{rank: result} of every rank of `ranks` (their processes `procs`)
    from the queue; raises RuntimeError with a failed rank's traceback or
    for a rank that exited without a result, and TimeoutError once
    time.monotonic() passes `end` or expired() holds."""
    out = {}
    while len(out) < len(ranks):
        left = end - time.monotonic()
        if left <= 0 or expired():
            raise TimeoutError(f"{who} did not finish in time")
        try:
            rank, ok, val = results.get(timeout=min(left, 1.0))
        except queue.Empty:
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            if dead and results.empty() and not expired():
                raise RuntimeError(
                    f"{who}: rank {ranks[procs.index(dead[0])]} exited with "
                    f"code {dead[0].exitcode} and no result")
            continue
        if not ok:
            raise RuntimeError(f"{who}: a rank failed\nrank {rank}:\n{val}")
        out[rank] = val
    return out


def _reap(procs: list, grace: float) -> None:
    """Join every process, killing those still alive after `grace` s."""
    for p in procs:
        p.join(timeout=grace)
        if p.is_alive():
            p.kill()
            p.join()


def _remove(own_dir: Optional[str]) -> None:
    if own_dir is not None:
        for name in os.listdir(own_dir):
            os.remove(os.path.join(own_dir, name))
        os.rmdir(own_dir)


def spawn(fn: Callable, world: int, args: Sequence = (), device="cuda",
          deadline: float = 600.0, store_dir: Optional[str] = None,
          threads: Optional[int] = 1) -> list:
    """fn(mesh, *args) on `world` spawned ranks -> their results in rank
    order (see the module docstring). threads: torch threads a rank (None
    leaves torch's default)."""
    dev = torch.device(device)
    _check_cards(dev, world, "spawn")
    store_path, own_dir = _store(store_dir)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = _start(ctx, fn, range(world), world, store_path, dev, threads,
                   args, results)
    out = {}
    try:
        out = _collect(procs, list(range(world)), results,
                       time.monotonic() + deadline,
                       f"spawn: {world} ranks of "
                       f"{getattr(fn, '__name__', fn)}")
    finally:
        _reap(procs, 10 if len(out) == world else 0)
        results.close()
        _remove(own_dir)
    return [out[r] for r in range(world)]


class Followers:
    """Ranks 1..world-1 of a group whose rank 0 is the calling process
    (`lead`). `mesh` is rank 0's parallel.mesh.Mesh; `join()` their
    results; `close()` ends them and the group. A context manager that
    closes on exit."""

    def __init__(self, mesh, procs: list, results, end: float,
                 own_dir: Optional[str], who: str):
        self.mesh, self.procs, self.results = mesh, procs, results
        self.end, self.own_dir, self.who = end, own_dir, who
        self.ranks = list(range(1, mesh.world))
        self.expired = threading.Event()
        self.timer = threading.Timer(max(end - time.monotonic(), 0.0),
                                     self._expire)
        self.timer.daemon = True
        self.timer.start()
        self.closed = False

    def _expire(self) -> None:
        self.expired.set()
        for p in self.procs:       # joined by join() or close()
            if p.is_alive():
                p.kill()

    def join(self) -> list:
        """The results of ranks 1..world-1 in rank order, waiting at most
        until the deadline. A rank that failed raises RuntimeError with its
        traceback, and past the deadline the ranks are killed and
        TimeoutError is raised; either way the ranks left are killed."""
        try:
            out = _collect(self.procs, self.ranks, self.results, self.end,
                           self.who, self.expired.is_set)
        except BaseException:
            _reap(self.procs, 0)
            raise
        self._leave(abort=False)
        _reap(self.procs, 10)
        return [out[r] for r in self.ranks]

    def _leave(self, abort: bool) -> None:
        """Leave the group: with the other ranks (they are leaving it), or
        alone after a failure, which aborts an NCCL communicator rather
        than wait for ranks that are gone."""
        if not dist.is_initialized():
            return
        abort_group = getattr(dist.distributed_c10d, "_abort_process_group",
                              None)
        if abort and dist.get_backend() == "nccl" and abort_group is not None:
            abort_group()
        else:
            dist.destroy_process_group()

    def close(self) -> None:
        """Kill the ranks still running, leave the group, remove the
        store (idempotent)."""
        if self.closed:
            return
        self.closed = True
        self.timer.cancel()
        _reap(self.procs, 0)
        self._leave(abort=True)
        self.results.close()
        _remove(self.own_dir)

    def __enter__(self) -> "Followers":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def lead(fn: Callable, world: int, args: Sequence = (), device="cuda",
         deadline: float = 600.0,
         store_dir: Optional[str] = None) -> Followers:
    """Join a new group of `world` ranks as its rank 0 and spawn fn(mesh,
    *args) on ranks 1..world-1, one torch thread each (see the module
    docstring; the caller's threads are left alone)."""
    from .mesh import make_mesh
    dev = torch.device(device)
    _check_cards(dev, world, "lead")
    if dist.is_initialized():
        raise RuntimeError("lead: this process is in a process group already")
    store_path, own_dir = _store(store_dir)
    ctx = mp.get_context("spawn")
    results, ready = ctx.Queue(), ctx.Queue()
    end = time.monotonic() + deadline
    who = f"lead: ranks 1-{world - 1} of {getattr(fn, '__name__', fn)}"
    procs = _start(ctx, fn, range(1, world), world, store_path, dev, 1, args,
                   results, deadline, ready)
    try:
        _await_start(procs, list(range(1, world)), ready, end, who)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(store_path, world), rank=0,
            world_size=world, timeout=datetime.timedelta(seconds=deadline))
        mesh = make_mesh(world, device=dev)
    except BaseException:
        _reap(procs, 0)
        if dist.is_initialized():
            dist.destroy_process_group()
        results.close()
        _remove(own_dir)
        raise
    finally:
        ready.close()
    return Followers(mesh, procs, results, end, own_dir, who)
