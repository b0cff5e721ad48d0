"""Sparse tensor containers: fixed-capacity padded voxel levels and points.

Counterpart of ``openpcseg_tpu/core/tensor.py`` as plain dataclasses of
tensors. A :class:`VoxelPyramid` holds every level's coords and every
kernel map the network needs, built once per step from the coords alone
(see core/geometry.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..ops.coords import Keys


@dataclass
class SparseLevel:
    """One resolution level; coords in the level's own grid units."""

    coords: torch.Tensor                  # [cap, 4] int32 (b, x, y, z); pad -1
    valid: torch.Tensor                   # [cap] bool
    keys: Keys                            # sorted key table
    stride: Tuple[int, int, int]          # tensor stride relative to level 0
    subm_kmap: Optional[torch.Tensor] = None  # [27, cap] into this level
    down_kmap: Optional[torch.Tensor] = None  # [8, cap] into the finer level
    up_kmap: Optional[torch.Tensor] = None    # [8, cap] into the coarser level
    up_one_hot: bool = False              # up_kmap fires one offset per row

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]


@dataclass
class PointBuffer:
    """The model-facing points; in the voxel modality these are the
    deduplicated level-0 sites."""

    coords: torch.Tensor  # [n, 3] float32 level-0 grid units
    batch: torch.Tensor   # [n] int32 (-1 padding)
    valid: torch.Tensor   # [n] bool


@dataclass
class DevoxTable:
    """8-corner devoxelize indices and trilinear weights at one level, and
    their transpose by voxel for the backward (ops.voxelize.
    devox_transpose_table). identity=True: the points ARE this level's
    rows (stride 1)."""

    idx: Optional[torch.Tensor]       # [8, n] int32 (-1 miss)
    weights: Optional[torch.Tensor]   # [8, n] float32
    identity: bool = False
    num_voxels: int = 0               # rows of the level (its capacity)
    t_ptr: Optional[torch.Tensor] = None     # [V + 1] int32 CSR offsets
    t_point: Optional[torch.Tensor] = None   # [8n] int32 contributor point
    t_weight: Optional[torch.Tensor] = None  # [8n] float32 its weight

    def apply(self, voxel_feats: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return voxel_feats
        from ..ops.devox import DevoxFn
        return DevoxFn.apply(voxel_feats, self)


@dataclass
class VoxelPyramid:
    """All level geometry and kernel maps for one network forward."""

    levels: Tuple[SparseLevel, ...]
    points: PointBuffer
    point_to_voxel0: torch.Tensor        # [n] int32 into level 0 (-1)
    devox: Dict[int, DevoxTable]         # level -> table
    level_counts: torch.Tensor           # [L] true voxel count per level
