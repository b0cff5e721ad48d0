"""Trilinear devoxelize: the wrapper of kernel K7.

Counterpart of ``openpcseg_tpu/ops/pallas_devox.py``; its forward kernel
``_fwd_kernel`` is replaced by ``csrc/devox.cu`` (one warp per point, lanes
over channels, f32 weights and sum, one cast at the store; the source says
what bounds it and why). The plain version is ``ops.voxelize._devox_apply``.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .voxelize import _devox_apply


def devoxelize(voxel_feats: torch.Tensor, idx: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """point[p] = sum_c weights[c, p] * voxel_feats[idx[c, p]]: [N, C] in
    the feature type. CPU tensors take the plain version; CUDA tensors
    launch the kernel (bf16 or f32 features, int32 idx, f32 weights)."""
    if not voxel_feats.is_cuda:
        return devoxelize_plain(voxel_feats, idx, weights)
    dev = voxel_feats.device
    n = idx.shape[1]
    c = voxel_feats.shape[1]
    entry = {torch.bfloat16: "opcs_devox_bf16",
             torch.float32: "opcs_devox_f32"}.get(voxel_feats.dtype)
    if entry is None:
        raise TypeError(f"devoxelize: no kernel for {voxel_feats.dtype}")
    cuda_lib.check_cuda(voxel_feats, "voxel_feats", voxel_feats.dtype, 2, dev)
    cuda_lib.check_cuda(idx, "idx", torch.int32, 2, dev)
    cuda_lib.check_cuda(weights, "weights", torch.float32, 2, dev)
    if idx.shape[0] != 8 or weights.shape != idx.shape:
        raise ValueError(f"devoxelize: idx {tuple(idx.shape)} / weights "
                         f"{tuple(weights.shape)} must both be [8, N]")
    out = torch.empty((n, c), dtype=voxel_feats.dtype, device=dev)
    cuda_lib.launch(entry, "devox", voxel_feats.data_ptr(), idx.data_ptr(),
                    weights.data_ptr(), out.data_ptr(), n, c)
    return out


def devoxelize_plain(voxel_feats, idx, weights):
    cuda_lib.note_plain("devox", voxel_feats)
    return _devox_apply(voxel_feats, idx, weights)
