"""Point <-> voxel transfer: mean-voxelize and the trilinear devoxelize's
plain versions.

Counterpart of ``openpcseg_tpu/ops/voxelize.py`` (the parts the voxel path
and SPVCNN use): ``voxelize_mean`` (SPVCNN's point-to-voxel mean),
``_devox_apply`` (forward, K7's plain version), ``_devox_bwd`` (its
transpose, K8's plain version), and ``devox_transpose_table`` with
``devox_segments``, the deterministic transpose table K8 walks and its cut
into bounded segments. The kernels that take these functions' place on
the card are in ``ops/devox.py``.
"""
from __future__ import annotations

import numpy as np
import torch


def voxelize_mean(point_feats: torch.Tensor, table) -> torch.Tensor:
    """Average point features into their voxel: out[v] = the mean of
    point_feats[p] over the points p with p2v[p] = v, 0 for an empty voxel
    (JAX ``voxelize_mean``: segment_sum / max(count, 1)). `table` is the
    level's one-corner table (``core.geometry.p2v_table``, idx [1, N] the
    p2v); differentiable through ``ops.devox.VoxelizeMeanFn``."""
    from .devox import VoxelizeMeanFn
    return VoxelizeMeanFn.apply(point_feats, table)


def corner_offsets() -> np.ndarray:
    """The 8 unit-cube corners, index = cx*4 + cy*2 + cz: [8, 3] int32."""
    return np.asarray([(dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                       for dz in (0, 1)], np.int32)


def _devox_apply(voxel_feats: torch.Tensor, idx: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """out[p] = sum_c weights[c, p] * voxel_feats[idx[c, p]] -> [N, C].

    Misses carry zero weight (the gather reads row 0 and adds nothing).
    Weights and the sum stay float32 and the result is cast to the feature
    type once, as the TPU kernel does (pallas_devox.py:434); for float32
    features this is JAX's ``_devox_apply`` exactly."""
    acc = torch.promote_types(voxel_feats.dtype, torch.float32)
    safe = idx.clamp(min=0).long()
    out = None
    for k in range(idx.shape[0]):
        contrib = voxel_feats[safe[k]].to(acc) * weights[k].to(acc)[:, None]
        out = contrib if out is None else out + contrib
    return out.to(voxel_feats.dtype)


def _devox_bwd(dout: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
               num_voxels: int) -> torch.Tensor:
    """Transpose of ``_devox_apply``: dvox[v] = sum over (c, p) with
    idx[c, p] = v of weights[c, p] * dout[p] -> [num_voxels, C] in dout's
    type (the forward feature type).

    The JAX ``xla_branch`` of ``pallas_devox._devox_pallas_bwd``
    (pallas_devox.py:459-468): 8 scatter-adds of (dout * w) formed at the
    forward precision and summed in float32 (float64 for float64)."""
    cdt = dout.dtype
    acc = torch.promote_types(cdt, torch.float32)
    out = torch.zeros((num_voxels, dout.shape[1]), dtype=acc,
                      device=dout.device)
    for k in range(idx.shape[0]):
        contrib = (dout * weights[k].to(cdt)[:, None]).to(acc)
        hit = idx[k] >= 0
        out.index_add_(0, idx[k].clamp(min=0).long(),
                       torch.where(hit[:, None], contrib,
                                   torch.zeros_like(contrib)))
    return out.to(cdt)


def devox_transpose_table(idx: torch.Tensor, weights: torch.Tensor,
                          num_voxels: int):
    """The CSR of idx [K, N] by voxel: (ptr [V + 1], point [KN], weight
    [KN]), int32 / int32 / float32. The contributors (corner c, point p) of
    voxel v are point[ptr[v]:ptr[v+1]] with their weights, in (c, p) order:
    a stable sort by voxel, misses (idx -1) last and outside every range;
    ptr[v] is the first sorted key >= v (a binary search per voxel)."""
    n = idx.shape[1]
    flat = idx.reshape(-1).long()
    key = torch.where(flat >= 0, flat, torch.full_like(flat, num_voxels))
    key, order = torch.sort(key, stable=True)
    ptr = torch.searchsorted(key, torch.arange(
        num_voxels + 1, device=idx.device), out_int32=True)
    point = (order % n).to(torch.int32)
    return ptr, point, weights.reshape(-1)[order].contiguous()


def devox_segments(t_ptr: torch.Tensor, n_contrib: int, chunk: int):
    """K8's work split of the transpose table of `n_contrib` (K N)
    contributors: each voxel's contributor range cut into segments of at
    most `chunk`, at least one per voxel (an empty voxel's segment writes
    its zero row). Returns seg_ptr [V + 1], the first segment of each
    voxel, and seg_voxel [V + ceil(KN / chunk)], the voxel of each segment
    (-1 past the last used one), both int32. Segment s of voxel v covers
    contributors t_ptr[v] + (s - seg_ptr[v]) * chunk up to the next chunk
    boundary or t_ptr[v + 1]. Sizes come from the capacities, so the launch
    needs no host sync: sum_v max(1, ceil(len_v / chunk)) <= V + KN /
    chunk."""
    v = t_ptr.shape[0] - 1
    nseg = ((t_ptr.diff() + chunk - 1) // chunk).clamp(min=1)
    seg_ptr = torch.cat([t_ptr.new_zeros(1), nseg.cumsum(0, dtype=torch.int32)])
    seg = torch.arange(v + -(-n_contrib // chunk), dtype=torch.int32,
                       device=t_ptr.device)
    owner = torch.searchsorted(seg_ptr[1:], seg, right=True, out_int32=True)
    return seg_ptr, torch.where(owner < v, owner, -1)
