"""Masked segment reductions over fixed-capacity padded buffers.

Counterpart of ``openpcseg_tpu/ops/segment.py`` (the parts the voxel path,
SPVCNN's mean-voxelize and Cylinder3D's scatter-max voxelize use). ``ids`` is int32 with -1 meaning
"dropped": such rows go to an overflow slot ``num_segments`` that is cut
off at the end. These are plain PyTorch: ``index_add_`` of floats is an
atomic add on a CUDA tensor, so the order of its sums, and their bits, vary
from run to run there; the card's mean-voxelize runs ``ops.devox
voxel_sum`` instead. ``segment_max`` is exact in any order (a max, and
its backward's tie counts are integer sums), so it stays plain on the card.
"""
from __future__ import annotations

import torch


def _route(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Map -1 / out-of-range ids to the overflow slot `num_segments`."""
    bad = (ids < 0) | (ids >= num_segments)
    return torch.where(bad, torch.full_like(ids, num_segments), ids).long()


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of `data` [N, ...] into `num_segments` buckets by `ids` [N]."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out.index_add_(0, _route(ids, num_segments), data)
    return out[:num_segments]


def segment_count(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Histogram of ids: [num_segments] int32."""
    return segment_sum(torch.ones_like(ids), ids, num_segments)


def segment_mean(data: torch.Tensor, ids: torch.Tensor, num_segments: int):
    """Mean-scatter -> (means, counts): the sum divided by max(count, 1)
    in the data's type; empty segments give 0."""
    s = segment_sum(data, ids, num_segments)
    cnt = segment_count(ids, num_segments)
    denom = cnt.clamp(min=1).to(data.dtype)
    return s / denom.reshape((-1,) + (1,) * (data.dim() - 1)), cnt


def segment_max(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max-scatter of rows of `data` [N, C] into `num_segments` buckets;
    empty segments give 0 and -1 ids are dropped (JAX ``segment_max``).
    Differentiable: the gradient of a maximum tied by several rows is split
    evenly over them, as ``jax.ops.segment_max``'s is."""
    route = _route(ids, num_segments)[:, None].expand_as(data)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    out = out.scatter_reduce(0, route, data, reduce="amax",
                             include_self=False)
    return out[:num_segments]


def segment_min_index(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """First-occurrence row index per segment (num rows where empty)."""
    n = ids.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=ids.device)
    out = torch.full((num_segments + 1,), n, dtype=torch.int32,
                     device=ids.device)
    out.scatter_reduce_(0, _route(ids, num_segments), iota, reduce="amin")
    return out[:num_segments]
