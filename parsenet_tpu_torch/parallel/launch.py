"""Spawn the ranks of one data-parallel run on this host.

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

fn must be importable by name (a module-level function), and its
arguments and result picklable. On cards rank r takes cuda:r (NCCL); gloo
only with device="cpu".
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch


def _rank_main(fn, rank: int, world: int, store_path: str, device: str,
               threads: Optional[int], args, results) -> None:
    import torch.distributed as dist

    from .mesh import make_mesh
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
        store = dist.FileStore(store_path, world)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=store, rank=rank, world_size=world)
        try:
            out = fn(make_mesh(world, device=device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, args: Sequence = (), device="cuda",
          deadline: float = 600.0, store_dir: Optional[str] = None,
          threads: Optional[int] = 1) -> list:
    """fn(mesh, *args) on `world` spawned ranks -> their results in rank
    order (see the module docstring). threads: torch threads a rank (None
    leaves torch's default)."""
    dev = torch.device(device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"spawn: {world} ranks asked for, but only "
                           f"{torch.cuda.device_count()} CUDA devices are "
                           "present")
    ctx = mp.get_context("spawn")
    own_dir = None
    if store_dir is None:
        own_dir = tempfile.mkdtemp(prefix="parsenet_store_")
        store_dir = own_dir
    store_path = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store_path, str(dev), threads,
                               tuple(args), results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, failures = {}, []
    end = time.monotonic() + deadline
    try:
        while len(out) + len(failures) < world:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {world} ranks of "
                                   f"{getattr(fn, '__name__', fn)} did not "
                                   f"finish within {deadline:.0f} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"spawn: rank {procs.index(dead[0])} exited with "
                        f"code {dead[0].exitcode} and no result")
                continue
            if ok:
                out[rank] = val
            else:
                failures.append(f"rank {rank}:\n{val}")
                break
        if failures:
            raise RuntimeError("spawn: a rank failed\n" + "\n".join(failures))
    finally:
        for p in procs:
            p.join(timeout=0 if failures or len(out) < world else 10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if own_dir is not None:
            for name in os.listdir(own_dir):
                os.remove(os.path.join(own_dir, name))
            os.rmdir(own_dir)
    return [out[r] for r in range(world)]
