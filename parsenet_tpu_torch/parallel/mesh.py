"""The device mesh as a torch.distributed process group.

Counterpart of parsenet_tpu/parallel/mesh.py. There a (data, model) mesh
of the local devices is one program, and XLA inserts the collectives. Here
each card is a process (a rank); `make_mesh` joins the process group that
a launcher made (torchrun, or `parallel.launch.spawn`), or makes a group of
one in a single process, and lays the ranks out as the JAX mesh lays out
devices: rank r has data index r // model_parallel, so ranks that share a
data index hold the same slice of a batch, as JAX's mesh replicates over
"model". Cards use NCCL; gloo serves only a run that asks for the CPU.

Every reduction of the data-parallel trainers and the sharded inference
goes through this module: `Mesh.all_sum`, `all_mean`, `all_reduce_grads`
and `gather_batch` (autograd through the gather); with one rank each is
the identity on the values, so a group of one computes what the ungrouped
code does. Each collective is one span while a profiler records
(core.profiling.trace): `dp.all_sum`, `dp.all_mean`, `dp.all_reduce_grads`
(its flatten and unflatten copies included) and `dp.gather_rows` (the
gather's forward, and its backward's all-reduce).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.guards import entry_device
from ..core.profiling import trace

DATA_AXIS = "data"
MODEL_AXIS = "model"
_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Mesh:
    """The ranks of one run laid out as (data, model).

    world: ranks in the group; rank: this process's; model_parallel: ranks
    a data index; shape: {"data": world // model_parallel, "model":
    model_parallel}; device: this rank's device (cuda:local_rank on cards);
    owns: whether make_mesh created the group (close() then destroys it)."""

    def __init__(self, world: int, rank: int, model_parallel: int,
                 device: torch.device, owns: bool):
        self.world, self.rank = world, rank
        self.model_parallel = model_parallel
        self.shape = {DATA_AXIS: world // model_parallel,
                      MODEL_AXIS: model_parallel}
        self.device, self.owns = device, owns

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that logs and writes files."""
        return self.rank == 0

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over every rank, as a new tensor (no gradient)."""
        with trace("dp.all_sum"):
            return _summed(t)

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of t over the ranks (no gradient)."""
        with trace("dp.all_mean"):
            return _summed(t) * (1.0 / self.world)

    def all_reduce_grads(self, params) -> None:
        """Every parameter's gradient becomes the mean over the ranks of
        its gradients: one all-reduce of them all, flattened, then 1 / world
        (a missing gradient counts as zeros and is filled in)."""
        params = list(params)
        with trace("dp.all_reduce_grads"):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            flat.mul_(1.0 / self.world)
            off = 0
            for p in params:
                n = p.grad.numel()
                p.grad.copy_(flat[off:off + n].view_as(p.grad))
                off += n

    def close(self) -> None:
        """Destroy the group where make_mesh created it."""
        if self.owns and dist.is_initialized():
            dist.destroy_process_group()
            self.owns = False


def _summed(t: torch.Tensor) -> torch.Tensor:
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


class _GatherRows(torch.autograd.Function):
    """all_gather ([world, *t.shape]) whose backward sums the output
    gradients over the ranks (one all-reduce) and keeps this rank's part."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.rank = mesh.rank
        with trace("dp.gather_rows"):
            out = [torch.empty_like(t) for _ in range(mesh.world)]
            dist.all_gather(out, t.contiguous())
            return torch.stack(out)

    @staticmethod
    def backward(ctx, grad):
        with trace("dp.gather_rows"):
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, op=dist.ReduceOp.SUM)
            return grad[ctx.rank], None


def gather_batch(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of t [B_local, ...]: every data index's rows
    in order ([B, ...]), with autograd through the gather (a rank's input
    gradient is its rows of the sum over the ranks of the output
    gradients). Without a mesh, or in a group of one, t itself: there is
    nothing to gather, and one rank then computes the ungrouped result,
    gradients included, bit for bit."""
    if mesh is None or mesh.world == 1:
        return t
    rows = _GatherRows.apply(t, mesh)[::mesh.model_parallel]
    return rows.reshape(-1, *t.shape[1:])


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def make_mesh(num_devices: int = 0, model_parallel: int = 1,
              device=None) -> Mesh:
    """The run's Mesh (parsenet_tpu/parallel/mesh.py:25-38).

    Joins the default process group where one exists, else makes one:
    from a launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT: torchrun), else a group of one in this process.
    num_devices = 0 takes the group's size; any other value must equal it
    (a single process cannot drive several cards: launch one rank a card).
    device None = "cuda": NCCL, rank r on cuda:LOCAL_RANK, and more ranks
    than this host's cards raise; gloo only for device="cpu". Never falls
    back to fewer cards or to the CPU."""
    dev = entry_device(device)
    _check_cards(dev, num_devices)
    backend = _backend(dev)
    owns = False
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"make_mesh: the process group runs {dist.get_backend()}, "
                f"but device {dev} needs {backend}")
    elif all(k in os.environ for k in _LAUNCH_ENV):
        _check_cards(dev, int(os.environ["WORLD_SIZE"]))
        _set_card(dev)
        dist.init_process_group(backend, init_method="env://")
        owns = True
    else:
        if num_devices > 1:
            raise RuntimeError(
                f"make_mesh: num_devices={num_devices} needs one process a "
                "card: launch with torchrun --nproc-per-node="
                f"{num_devices} (or parallel.launch.spawn)")
        _check_cards(dev, 1)
        _set_card(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        owns = True
    world, rank = dist.get_world_size(), dist.get_rank()
    try:
        if num_devices and num_devices != world:
            raise RuntimeError(f"make_mesh: num_devices={num_devices}, but "
                               f"the process group has {world} ranks")
        _check_cards(dev, world)
        if world % model_parallel:
            raise ValueError(f"{world} devices not divisible by "
                             f"model_parallel={model_parallel}")
    except Exception:
        if owns:
            dist.destroy_process_group()
        raise
    return Mesh(world, rank, model_parallel, _rank_device(dev), owns)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def _check_cards(dev: torch.device, world: int) -> None:
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"make_mesh: {world} ranks asked for, but only "
                           f"{torch.cuda.device_count()} CUDA devices are "
                           "present")


def _rank_device(dev: torch.device) -> torch.device:
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", torch.cuda.current_device())


def _set_card(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else _local_rank())


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Shapes a data index holds (parsenet_tpu/parallel/mesh.py:61-65)."""
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} data shards")
    return global_batch // n


def shard_slice(global_batch: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a batch axis of global_batch (all of it without
    a mesh)."""
    if mesh is None:
        return slice(0, global_batch)
    b = local_batch_size(global_batch, mesh)
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def shard_batch(mesh: Optional[Mesh], batch, axis: int = 0):
    """This rank's slice of every array or tensor of `batch` (tuples,
    lists and dicts of them; None stays None) along `axis`."""
    if isinstance(batch, (tuple, list)):
        items = [shard_batch(mesh, b, axis) for b in batch]
        return type(batch)(*items) if hasattr(batch, "_fields") \
            else type(batch)(items)
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    if batch is None or mesh is None:
        return batch
    s = shard_slice(batch.shape[axis], mesh)
    return batch[(slice(None),) * axis + (s,)]


def replicate(mesh: Mesh, tensors):
    """Rank 0's values of every tensor in `tensors` (a module's parameters
    and buffers, or an iterable of tensors), broadcast in place."""
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, 0)
    return tensors
