"""Data-parallel training and evaluation over torch.distributed.

Counterpart of ``openpcseg_tpu/parallel/mesh.py``. JAX runs one program
over a 1-D 'data' mesh and shard_maps the steps over it; here one process
per rank (``torchrun``) holds the whole model, loads its own slice of each
global batch (``data.BatchLoader`` with the rank as its
``process_index``), and runs the collectives where JAX's steps run theirs
under ``axis_name``, in a ``SegTask`` built with ``group``:

    JAX (mesh.py, task.py, layers.py)       port
    make_data_mesh, init_distributed        init_distributed
    shard_train_step                        shard_train_step
    pmean of the grads (task.py:381-382)    average_gradients, before the clip
    pmean of the loss, psum of num_voxels
    and voxel_overflow (task.py:383-385)    reduce_train_metrics
    psum of the eval histogram
    (task.py:564, :592), shard_eval_step    SegTask.eval_step sums it itself
    MaskedBatchNorm(axis_name)              sync_batchnorm: cnt, s1, s2 summed
    (layers.py:205-208)                     by all_reduce_sum, differentiable
    psum of EQLv2's d_pos / d_neg           Losses(group=...): eqlv2_loss sums
    (longtail.py:271-273)                   them by all_reduce_sum, so every
                                            rank's buffers stay the same
    device 0's batch_stats in the
    replicated state                        broadcast_buffers after each step
    global_batch_arrays                     none: each rank keeps its own
                                            slice; no global batch is built

The backend is NCCL where every rank of the host has a card of its own,
gloo where ranks share a card or run on the CPU (NCCL refuses two ranks on
one device). Gloo reduces and broadcasts CUDA tensors, which is all this
module asks of it; it has no CUDA all_gather, and nothing here uses one.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist


def init_distributed(device: str = "cuda", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None
                     ) -> Tuple[int, int, torch.device]:
    """This process's (rank, world size, device). The rank and world come
    from torchrun's RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE (or
    the arguments); the default process group is made when the process is
    one of a launched group (WORLD_SIZE set, or `init_method` given, e.g.
    ``file://<path>``), and a run of one plain process makes none. On the
    card the device is ``cuda:{LOCAL_RANK % device_count}``; ``device="cpu"``
    keeps every rank on the CPU (JAX ``init_distributed``, mesh.py:96-116,
    reads the JAX coordinator's variables instead)."""
    env = os.environ
    launched = init_method is not None or "WORLD_SIZE" in env
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("init_distributed: torch sees no CUDA device "
                               "(--device cpu runs on the CPU)")
        dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)
        backend = "nccl" if n >= local_world else "gloo"
    if launched and not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    return rank, world, dev


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the cotangents over the ranks
    too: each rank's statistic feeds every rank's loss, so its gradient is
    the sum of every rank's share (a plain ``dist.all_reduce`` would keep
    this rank's share only)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of `group` (JAX psum)."""
    return _AllReduceSum.apply(x, group)


def sync_batchnorm(model: torch.nn.Module, group) -> None:
    """Every MaskedBatchNorm of `model` sums its statistics over `group`
    (JAX passes ``axis_name`` to each one of MinkUNet, SPVCNN, Cylinder3D
    and RPVNet's voxel and point branches). The range models' BatchNorm2d,
    RPVNet's range branch among them, stay per rank, as flax's
    ``nn.BatchNorm`` without ``axis_name`` does."""
    from ..models.layers import MaskedBatchNorm

    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.group = group


def average_gradients(params: Iterable[torch.nn.Parameter], group) -> None:
    """Every gradient becomes its mean over the ranks, in place, through one
    flattened all-reduce. The models' graphs do not depend on the data, so
    every rank's backward reaches the same parameters."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def reduce_train_metrics(metrics: dict, group) -> dict:
    """A train step's metrics over the ranks: the loss's mean, the sums of
    num_voxels and voxel_overflow (JAX task.py:383-385), in one reduce."""
    world = dist.get_world_size(group)
    keys = ("loss", "num_voxels", "voxel_overflow")
    v = torch.stack([metrics[k].detach().double().reshape(()) for k in keys])
    dist.all_reduce(v, group=group)
    v[0] /= world
    return dict(metrics, **{k: v[i].to(metrics[k].dtype)
                            for i, k in enumerate(keys)})


def _broadcast(tensors, group) -> None:
    """Rank 0's values of `tensors`, in place, one broadcast per dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    src = dist.get_global_rank(group, 0)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        at = 0
        for t in ts:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()


@torch.no_grad()
def broadcast_buffers(model: torch.nn.Module, group) -> None:
    """Rank 0's buffers (the BN running statistics) on every rank: the
    synced BNs hold the same statistics everywhere already, the per-rank
    ones (the range models') take rank 0's, as JAX's replicated state
    takes device 0's and DDP's ``broadcast_buffers`` does."""
    _broadcast(list(model.buffers()), group)


def shard_train_step(task):
    """JAX ``shard_train_step`` (mesh.py:60-78): the state replicated, then
    one step per call on this rank's slice. Every rank takes rank 0's
    parameters and buffers once (as DDP does when it wraps a model); each
    call is ``task.train_step``, whose collectives run inside it."""
    if task.group is not None:
        with torch.no_grad():
            _broadcast(list(task.model.parameters())
                       + list(task.model.buffers()), task.group)
    return task.train_step


def shutdown() -> None:
    """Destroy the default process group, where one was made, so a
    launched rank ends without a dangling group."""
    if dist.is_initialized():
        dist.destroy_process_group()
