"""Batch voxelization: padded point scans -> sparse voxel batch.

Counterpart of ``openpcseg_tpu/core/batch.py`` (``voxelize_points_batch``):
round(xyz / voxel_size), min-shift per scan, first-point dedup into a
fixed-capacity key-sorted voxel table, and the point -> voxel inverse map
for re-projecting predictions.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.coords import unique_coords
from ..ops.segment import segment_min_index

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
    voxel_rep: torch.Tensor      # [V] int32 first point of each voxel (-1)


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
