"""Sparse tensor containers: fixed-capacity padded voxel levels and points.

Counterpart of ``openpcseg_tpu/core/tensor.py`` as plain dataclasses of
tensors. A :class:`VoxelPyramid` holds every level's coords and every
kernel map the network needs, built once per step from the coords alone
(see core/geometry.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.coords import Keys
from ..ops.kmap import subm_subset_indices


@dataclass
class ParityPlan:
    """The k2/s2 pairs of one coarse level grouped by parity, for the
    parent-gather kernel (csrc/parent_gemm.cu: K4 and K6's dfeats).

    Slot s pairs fine row ``dst_rows[s]`` with coarse row ``src_rows[s]``.
    Slots ``[group_offsets[p], group_offsets[p + 1])`` hold parity p
    (p < 8, kernel_offsets(2) order), both row lists ascending; group 8
    holds the fine rows without a parent (``src_rows`` -1), whose output
    rows are zero. Every fine row has exactly one slot. Group g is cut into
    tiles of ``tile_rows`` slots, numbered from ``tile_offsets[g]``;
    ``tile_offsets[9]`` tiles are used of the ``max_tiles`` the kernel is
    launched with (a bound from the capacity, so no host sync)."""

    src_rows: torch.Tensor       # [N_fine] int32 coarse row (-1: no parent)
    dst_rows: torch.Tensor       # [N_fine] int32 fine row
    group_offsets: torch.Tensor  # [10] int32
    tile_offsets: torch.Tensor   # [10] int32
    tile_rows: int
    max_tiles: int


@dataclass
class SparseLevel:
    """One resolution level; coords in the level's own grid units."""

    coords: torch.Tensor                  # [cap, 4] int32 (b, x, y, z); pad -1
    valid: torch.Tensor                   # [cap] bool
    keys: Keys                            # sorted key table
    stride: Tuple[int, int, int]          # tensor stride relative to level 0
    subm_kmap: Optional[torch.Tensor] = None  # [27, cap] into this level
    # [K, cap] into the finer level: K 8 for the k2/s2 maps, 27 for k3
    down_kmap: Optional[torch.Tensor] = None
    up_kmap: Optional[torch.Tensor] = None    # [K, cap] into the coarser level
    up_one_hot: bool = False              # up_kmap fires one offset per row
    # k2/s2 only (None otherwise): down_kmap's pairs grouped by parity, for
    # the up conv into the finer level and the backward of the down conv
    # into this one
    parity_plan: Optional[ParityPlan] = None
    # anisotropic kernel size -> its rows of subm_kmap (subm_subset)
    subsets: Dict[tuple, torch.Tensor] = field(default_factory=dict,
                                               repr=False)

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    def subm_subset(self, kernel_size) -> torch.Tensor:
        """[K, cap]: the rows of the 3^3 ``subm_kmap`` of a centred odd
        sub-kernel, in its ``kernel_offsets`` order (Cylinder3D's
        anisotropic convs); made once per level and kernel, then shared by
        every conv of that kernel."""
        key = tuple(kernel_size)
        if key == (3, 3, 3):
            return self.subm_kmap
        if key not in self.subsets:
            rows = torch.as_tensor(subm_subset_indices(3, key),
                                   device=self.subm_kmap.device).long()
            self.subsets[key] = self.subm_kmap[rows].contiguous()
        return self.subsets[key]


@dataclass
class PointBuffer:
    """The model-facing points; in the voxel modality these are the
    deduplicated level-0 sites, for Cylinder3D the scans' points."""

    coords: torch.Tensor  # [n, 3] float32 level-0 grid units
    batch: torch.Tensor   # [n] int32 (-1 padding)
    valid: torch.Tensor   # [n] bool


@dataclass
class DevoxTable:
    """Devoxelize indices and weights at one level, K corners a point (8
    trilinear corners, or the one voxel of a point-to-voxel table), their
    transpose by voxel for the backward (ops.voxelize.
    devox_transpose_table) and its cut into segments of at most `chunk`
    contributors (ops.voxelize.devox_segments); core.geometry.devox_table
    builds all of it. Segment s belongs to voxel seg_voxel[s] (-1 past the
    last) and covers contributors t_ptr[v] + (s - seg_ptr[v]) * chunk
    onwards; every voxel has at least one (an empty voxel's zero row is
    written by it). identity=True: the points ARE this level's rows
    (stride 1)."""

    idx: Optional[torch.Tensor]       # [K, n] int32 (-1 miss)
    weights: Optional[torch.Tensor]   # [K, n] float32
    identity: bool = False
    num_voxels: int = 0               # rows of the level (its capacity)
    t_ptr: Optional[torch.Tensor] = None     # [V + 1] int32 CSR offsets
    t_point: Optional[torch.Tensor] = None   # [Kn] int32 contributor point
    t_weight: Optional[torch.Tensor] = None  # [Kn] float32 its weight
    seg_ptr: Optional[torch.Tensor] = None   # [V + 1] int32 first segment
    seg_voxel: Optional[torch.Tensor] = None  # [V + Kn/chunk] int32 (-1)
    chunk: int = 0                    # contributors a segment holds at most

    def apply(self, voxel_feats: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return voxel_feats
        from ..ops.devox import DevoxFn
        return DevoxFn.apply(voxel_feats, self)


@dataclass
class VoxelPyramid:
    """All level geometry and kernel maps for one network forward.

    ``p2v[l]`` is the point-to-voxel table of level l that SPVCNN's
    mean-voxelize and Cylinder3D's refinement gather walk: a one-corner
    DevoxTable (core.geometry.p2v_table) whose ``idx`` [1, n] is JAX's
    ``p2v[l]``, each point's level-l voxel (-1 none). ``range`` maps a
    range resolution (H, W) to RPVNet's tables between the points and that
    range map (``ops.range_fusion.RangeTables``), built with the pyramid
    for a fusion-input model."""

    levels: Tuple[SparseLevel, ...]
    points: PointBuffer
    point_to_voxel0: torch.Tensor        # [n] int32 into level 0 (-1)
    devox: Dict[int, DevoxTable]         # level -> table
    level_counts: torch.Tensor           # [L] true voxel count per level
    p2v: Dict[int, DevoxTable] = field(default_factory=dict)
    range: Dict[Tuple[int, int], Any] = field(default_factory=dict)
