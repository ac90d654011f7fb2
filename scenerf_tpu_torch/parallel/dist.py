"""Ranks, groups and collectives: the counterpart of
`scenerf_tpu/parallel/mesh.py`. The JAX package runs one program over a 1-D
device mesh (gradients, metrics and batch-norm statistics psum'd inside it);
the port runs one process per rank under `torch.distributed`, started by
`torchrun`, with the collectives outside the kernels:

    torchrun --nproc_per_node 4 -m scenerf_tpu_torch.cli.train train-kitti \\
        --parallel_mode data --bs 4 ...

`init` reads torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT). Without it (or with WORLD_SIZE 1) the world is one
rank with no process group, and every caller takes its one-device path
unchanged. Rank r takes the card cuda:{LOCAL_RANK} unless a device is named
(then every rank takes that one: two ranks can share one card over gloo);
the backend is NCCL on CUDA and gloo on the CPU unless one is named. A rank
that does not join, or a collective that does not end, raises after the
group's timeout on every rank that waits: nothing falls back.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0  # a collective (or the rendezvous) waits this long, then raises


class World(NamedTuple):
    rank: int
    size: int
    device: Optional[torch.device]
    group: Optional[object]  # the process group (None: a world of one rank)
    backend: Optional[str]


_world = World(0, 1, None, None, None)
_owned = False  # whether init created the default process group


def env_ranks() -> Tuple[int, int, int]:
    """(rank, world size, local rank) from torchrun's environment; (0, 1, 0)
    without it."""
    size = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    if size < 1 or not 0 <= rank < size:
        raise RuntimeError(f"torchrun environment: RANK {rank} of WORLD_SIZE {size}")
    return rank, size, local


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` where named, else cuda:{LOCAL_RANK}; raises
    when CUDA is absent or the node has fewer cards than local ranks."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev}: no CUDA device here (name cpu for the CPU)")
        return dev
    rank, size, local = env_ranks()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name cpu for the CPU")
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(f"WORLD_SIZE {size}: local rank {local} has no card of its own "
                           f"({n} visible); name one device for every rank to share it")
    return torch.device("cuda", local)


def init(device=None, backend: Optional[str] = None, timeout_s: float = TIMEOUT_S) -> World:
    """Join torchrun's world (see the module docstring) and return it. Under a
    world of one rank no process group is made."""
    global _world, _owned
    rank, size, _ = env_ranks()
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if size == 1:
        _world = World(0, 1, dev, None, None)
        return _world
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        _owned = True
    elif dist.get_world_size() != size or dist.get_rank() != rank:
        raise RuntimeError("a process group of another world is already initialized")
    _world = World(rank, size, dev, dist.group.WORLD, dist.get_backend())
    return _world


def shutdown() -> None:
    """Leave the world init joined (destroy the process group it made)."""
    global _world, _owned
    if _owned and dist.is_initialized():
        dist.destroy_process_group()
    _owned = False
    _world = World(0, 1, None, None, None)


def size(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None) -> int:
    return 0 if group is None else dist.get_rank(group)


def barrier(group=None) -> None:
    if group is not None:
        dist.barrier(group=group)


def local_batch_size(global_batch: int, world_size: int) -> int:
    """The items of each rank's share of a global batch; raises unless the
    world divides it."""
    if global_batch % world_size:
        raise ValueError(f"global batch {global_batch} not divisible by the world's "
                         f"{world_size} ranks")
    return global_batch // world_size


# ------------------------------------------------------------ collectives


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """SUM over the group, in place; the identity without one."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """MEAN over the group, in place (a SUM, then / size: gloo has no AVG)."""
    if group is not None:
        all_reduce_sum(t, group).div_(size(group))
    return t


def all_reduce_metrics(metrics: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """A dict of scalar tensors averaged over the group in one collective (JAX
    `pmean(metrics)`)."""
    if group is None or not metrics:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    all_reduce_mean(flat, group)
    return {k: flat[i] for i, k in enumerate(keys)}


class _SumOverRanks(torch.autograd.Function):
    """SUM over the group; its backward is a SUM over the group too (the
    transpose of JAX's psum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(memory_format=torch.contiguous_format), ctx.group), None


def sum_over_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """`t` summed over the group, differentiably (JAX `psum` in a shard_map
    step); `t` itself without a group."""
    return t if group is None else _SumOverRanks.apply(t, group)


def average_gradients(params: Sequence[torch.nn.Parameter], group=None) -> None:
    """Every parameter's gradient replaced by its mean over the group (JAX
    `pmean(grads)`), in one collective per dtype and device. A parameter
    without a gradient takes zeros on every rank, so the ranks stay in step."""
    if group is None:
        return
    buckets: Dict[tuple, list] = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        buckets.setdefault((p.grad.dtype, p.grad.device), []).append(p)
    n = size(group)
    for ps in buckets.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        all_reduce_sum(flat, group).div_(n)
        at = 0
        for p in ps:
            k = p.grad.numel()
            p.grad.copy_(flat[at:at + k].view_as(p.grad))
            at += k


def broadcast_tensors(tensors: Sequence[torch.Tensor], group=None, src: int = 0) -> None:
    """Every tensor set to rank `src`'s, in place, one collective per dtype
    and device."""
    if group is None:
        return
    buckets: Dict[tuple, list] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    nccl = dist.get_backend(group) == "nccl"
    for ts in buckets.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        if nccl and flat.device.type == "cpu":  # NCCL moves CUDA tensors only
            flat = flat.to(_world.device)
        dist.broadcast(flat, src=src, group=group)
        at = 0
        with torch.no_grad():
            for t in ts:
                k = t.numel()
                t.copy_(flat[at:at + k].view_as(t))
                at += k


def broadcast_module(module: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                     group=None) -> None:
    """Rank 0's parameters, buffers and optimizer state on every rank (the
    part of JAX's `replicate`): every rank then starts from the same
    state."""
    if group is None:
        return
    tensors = list(module.parameters()) + list(module.buffers())
    if optimizer is not None:
        for st in optimizer.state.values():
            tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    broadcast_tensors(tensors, group)


def broadcast_object(obj, group=None, src: int = 0):
    """A picklable object from rank `src` on every rank."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def gather_rows(t: torch.Tensor, n: int, group=None) -> Optional[torch.Tensor]:
    """Each rank's contiguous rows of an [n, ...] result (ceil(n / size)
    each, the last ones fewer) gathered on rank 0 in rank order: the [n,
    ...] whole there, None on the other ranks."""
    if group is None:
        return t
    k = size(group)
    per = -(-n // k)
    padded = t.new_zeros((per, *t.shape[1:]))
    padded[:t.shape[0]] = t
    if dist.get_backend(group) == "gloo":  # gloo gathers host tensors only
        padded = padded.cpu()
    me = rank(group)
    parts = [torch.empty_like(padded) for _ in range(k)] if me == 0 else None
    dist.gather(padded, parts, dst=0, group=group)
    if me != 0:
        return None
    return torch.cat(parts)[:n].to(t.device)
