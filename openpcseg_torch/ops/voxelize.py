"""Point <-> voxel transfer: the trilinear devoxelize's plain version.

Counterpart of ``openpcseg_tpu/ops/voxelize.py`` (the parts the voxel eval
path uses). The kernel that takes this function's place on the card is in
``ops/devox.py``.
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
    safe = idx.clamp(min=0).long()
    out = None
    for k in range(idx.shape[0]):
        contrib = voxel_feats[safe[k]].float() * weights[k].float()[:, None]
        out = contrib if out is None else out + contrib
    return out.to(voxel_feats.dtype)
