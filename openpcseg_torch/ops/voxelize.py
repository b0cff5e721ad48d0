"""Point <-> voxel transfer: the trilinear devoxelize's plain versions.

Counterpart of ``openpcseg_tpu/ops/voxelize.py`` (the parts the voxel path
uses): ``_devox_apply`` (forward, K7's plain version), ``_devox_bwd``
(its transpose, K8's plain version) and ``devox_transpose_table``, the
deterministic transpose table K8 walks. The kernels that take these
functions' place on the card are in ``ops/devox.py``.
"""
from __future__ import annotations

import numpy as np
import torch


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
    """The CSR of idx [8, N] by voxel: (ptr [V + 1], point [8N], weight
    [8N]), int32 / int32 / float32. The contributors (corner c, point p) of
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
