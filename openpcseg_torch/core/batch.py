"""Batch voxelization: padded point scans -> sparse voxel batch.

Counterpart of ``openpcseg_tpu/core/batch.py``:

- ``voxelize_points_batch`` (voxel and fusion modalities): round(xyz /
  voxel_size), min-shift per scan, first-point dedup into a
  fixed-capacity key-sorted voxel table, and the point -> voxel inverse map
  for re-projecting predictions;
- ``cylinder_points_batch`` (Cylinder3D): the cylindrical partition of the
  points, their 9-wide features, the same dedup, and each voxel's
  majority label.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..ops.coords import unique_coords
from ..ops.segment import segment_min_index, segment_sum

INT32_MAX = 2 ** 31 - 1


@dataclass
class VoxelBatch:
    voxel_coords: torch.Tensor   # [V, 4] int32 key-sorted; pad -1
    voxel_valid: torch.Tensor    # [V] bool
    voxel_keys_hi: torch.Tensor  # [V] int32 sorted key table
    voxel_keys_lo: torch.Tensor
    voxel_feats: torch.Tensor    # [V, C] first-point features (pad 0)
    voxel_labels: torch.Tensor   # [V] int32 (pad -1)
    inverse_map: torch.Tensor    # [B*Np] int32 point -> voxel row (-1 dropped)
    point_labels: torch.Tensor   # [B*Np] int32
    point_valid: torch.Tensor    # [B*Np] bool
    point_batch: torch.Tensor    # [B*Np] int32 scan of each point (-1 pad)
    num_voxels: torch.Tensor     # [] int32 true voxel count (may exceed V)
    voxel_rep: Optional[torch.Tensor] = None  # [V] int32 first point (-1)
    # point-input models (Cylinder3D): each point's features and its float
    # grid cell (level-0 units) for the geometry pass
    point_feats: Optional[torch.Tensor] = None   # [B*Np, C]
    point_grid: Optional[torch.Tensor] = None    # [B*Np, 3] float32


def voxelize_points_batch(xyz: torch.Tensor, feats: torch.Tensor,
                          labels: torch.Tensor, valid: torch.Tensor, *,
                          voxel_size: float, voxel_cap: int) -> VoxelBatch:
    """xyz [B, Np, 3] f32, feats [B, Np, C], labels [B, Np], valid [B, Np]."""
    b, n_pts, _ = xyz.shape
    dev = xyz.device
    grid = torch.round(xyz / voxel_size).to(torch.int32)
    masked = torch.where(valid[..., None], grid,
                         torch.full_like(grid, INT32_MAX))
    mins = masked.min(dim=1, keepdim=True).values
    mins = torch.where(mins == INT32_MAX, torch.zeros_like(mins), mins)
    grid = grid - mins

    batch_idx = torch.arange(b, dtype=torch.int32,
                             device=dev)[:, None].expand(b, n_pts)
    flat_coords = torch.cat([batch_idx.reshape(-1, 1), grid.reshape(-1, 3)],
                            dim=1)
    flat_valid = valid.reshape(-1)
    flat_feats = feats.reshape(b * n_pts, -1)
    flat_labels = labels.reshape(-1).to(torch.int32)

    uniq = unique_coords(flat_coords, flat_valid, voxel_cap)
    rep = segment_min_index(uniq.inverse, voxel_cap)
    rep_safe = rep.clamp(max=b * n_pts - 1).long()
    voxel_feats = torch.where(uniq.valid[:, None], flat_feats[rep_safe],
                              torch.zeros((), dtype=flat_feats.dtype,
                                          device=dev))
    minus1 = torch.full((voxel_cap,), -1, dtype=torch.int32, device=dev)
    return VoxelBatch(
        voxel_coords=uniq.coords,
        voxel_valid=uniq.valid,
        voxel_keys_hi=uniq.keys.hi,
        voxel_keys_lo=uniq.keys.lo,
        voxel_feats=voxel_feats,
        voxel_labels=torch.where(uniq.valid, flat_labels[rep_safe], minus1),
        inverse_map=uniq.inverse,
        point_labels=flat_labels,
        point_valid=flat_valid,
        point_batch=torch.where(flat_valid, batch_idx.reshape(-1),
                                torch.full_like(flat_labels, -1)),
        num_voxels=uniq.num_unique,
        voxel_rep=torch.where(uniq.valid, rep_safe.to(torch.int32), minus1),
    )


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as the fused multiply-add XLA makes
    of it: the float64 product of two float32 values is exact, so only the
    sum rounds (twice, f64 then f32, which differs from one rounding only
    on an exact f32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def cart2polar(xyz: torch.Tensor) -> torch.Tensor:
    """(rho, phi, z): rho = sqrt(x * x + y * y) with the sum fused into
    x's product, and phi = atan2(y, x); float32, in the order XLA computes
    JAX's ``cart2polar``."""
    x, y = xyz[..., 0], xyz[..., 1]
    rho = torch.sqrt(_fma(x, x, y * y))
    return torch.stack([rho, torch.atan2(y, x), xyz[..., 2]], dim=-1)


def cylinder_points_batch(xyz: torch.Tensor, extra: torch.Tensor,
                          labels: torch.Tensor, valid: torch.Tensor, *,
                          space_min: Sequence[float],
                          space_max: Sequence[float],
                          grid_size: Sequence[int], voxel_cap: int,
                          num_class: int) -> VoxelBatch:
    """The cylindrical partition of Cylinder3D (JAX ``cylinder_points_batch``,
    flat tables): xyz [B, Np, 3] f32 -> (rho, phi in degrees, z), clipped to
    [space_min, space_max], grid cell floor((clipped - min) / interval)
    with interval = (max - min) / (grid - 1); point features [cell centre
    rho/phi/z, rho/phi/z, x, y, extra...] (extra [B, Np, E], the
    intensity); the cells deduplicated into the key-sorted voxel table; each
    voxel's label the majority of its points' (ties to the lowest id);
    voxel features zeros [cap, 1] (the model's input is the points').

    The arithmetic is the one XLA compiles JAX's into on the CPU: the
    division by the interval a multiplication by its float32 reciprocal,
    the centre's and rho's multiply-adds fused (``_fma``); so the cells
    come out as JAX's, and the features within a rounding of JAX's (XLA's
    own square root differs from a correctly rounded one by an ulp on ~2%
    of the points)."""
    b, n_pts, _ = xyz.shape
    dev = xyz.device
    mn = torch.tensor(space_min, dtype=torch.float32, device=dev)
    mx = torch.tensor(space_max, dtype=torch.float32, device=dev)
    gs = torch.tensor(grid_size, dtype=torch.float32, device=dev)
    intervals = (mx - mn) / (gs - 1.0)

    pol = cart2polar(xyz)
    deg = torch.tensor([1.0, 180.0 / math.pi, 1.0], dtype=torch.float32,
                       device=dev)
    pol = pol * deg
    clipped = torch.minimum(torch.maximum(pol, mn), mx)
    grid = torch.floor((clipped - mn) * (1.0 / intervals)).to(torch.int32)
    centers = _fma(grid.float() + 0.5, intervals.expand_as(pol),
                   mn.expand_as(pol))
    feats = torch.cat([centers, pol, xyz[..., :2], extra], dim=-1)

    batch_idx = torch.arange(b, dtype=torch.int32,
                             device=dev)[:, None].expand(b, n_pts)
    flat_coords = torch.cat([batch_idx.reshape(-1, 1), grid.reshape(-1, 3)],
                            dim=1)
    flat_valid = valid.reshape(-1)
    flat_labels = labels.reshape(-1).to(torch.int32)
    uniq = unique_coords(flat_coords, flat_valid, voxel_cap)

    onehot = torch.nn.functional.one_hot(
        flat_labels.clamp(0, num_class - 1).long(), num_class).to(torch.int32)
    onehot = onehot * flat_valid[:, None].to(torch.int32)
    counts = segment_sum(onehot, uniq.inverse, voxel_cap)
    voxel_labels = torch.where(uniq.valid, counts.argmax(dim=-1).to(
        torch.int32), torch.full((voxel_cap,), -1, dtype=torch.int32,
                                 device=dev))
    return VoxelBatch(
        voxel_coords=uniq.coords,
        voxel_valid=uniq.valid,
        voxel_keys_hi=uniq.keys.hi,
        voxel_keys_lo=uniq.keys.lo,
        voxel_feats=torch.zeros((voxel_cap, 1), dtype=torch.float32,
                                device=dev),
        voxel_labels=voxel_labels,
        inverse_map=uniq.inverse,
        point_labels=flat_labels,
        point_valid=flat_valid,
        point_batch=torch.where(flat_valid, batch_idx.reshape(-1),
                                torch.full_like(flat_labels, -1)),
        num_voxels=uniq.num_unique,
        point_feats=feats.reshape(b * n_pts, -1),
        point_grid=grid.reshape(-1, 3).float(),
    )
