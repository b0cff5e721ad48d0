"""Trilinear devoxelize: the wrappers of kernels K7 and K8.

Counterpart of ``openpcseg_tpu/ops/pallas_devox.py``:

- K7, the forward kernel ``_fwd_kernel``, is replaced by the point gather
  of ``csrc/devox.cu`` (a warp per tile of 8 points, their corner table
  read with lanes over points, C / 8 lanes per point, f32 weights and sum,
  one cast and one 16-byte store a lane); plain version
  ``ops.voxelize._devox_apply``.
- K8, the transpose kernel ``_bwd_kernel`` (via ``_run_bwd`` from
  ``_devox_pallas_bwd``), is replaced by the voxel gather of
  ``csrc/devox.cu`` over the CSR transpose table
  (``ops.voxelize.devox_transpose_table``) cut into segments of at most
  ``table.chunk`` contributors (``ops.voxelize.devox_segments``): a warp
  per segment, the f32 partials of a voxel cut in several added in segment
  order by the last warp to finish; plain version
  ``ops.voxelize._devox_bwd``.

``DevoxFn`` is the autograd Function over both. The source says what
bounds each kernel and why.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .voxelize import _devox_apply, _devox_bwd

_ENTRIES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _entry(name: str, dtype: torch.dtype) -> str:
    if dtype not in _ENTRIES:
        raise TypeError(f"{name}: no kernel for {dtype}")
    return f"opcs_{name}_{_ENTRIES[dtype]}"


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
    entry = _entry("devox", voxel_feats.dtype)
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


def devoxelize_bwd(dout: torch.Tensor, table) -> torch.Tensor:
    """K8: dvox [V, C] in dout's type (the forward feature type) for the
    upstream gradient dout [N, C] of ``devoxelize`` over `table`
    (core.tensor.DevoxTable with its transpose and segment fields, as
    core.geometry.devox_table builds it). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if not dout.is_cuda:
        return devoxelize_bwd_plain(dout, table)
    dev = dout.device
    dout = dout.contiguous()
    entry = _entry("devox_bwd", dout.dtype)
    cuda_lib.check_cuda(dout, "dout", dout.dtype, 2, dev)
    for name, dtype in (("t_ptr", torch.int32), ("t_point", torch.int32),
                        ("t_weight", torch.float32), ("seg_ptr", torch.int32),
                        ("seg_voxel", torch.int32)):
        cuda_lib.check_cuda(getattr(table, name), name, dtype, 1, dev)
    n_vox, n = table.num_voxels, table.idx.shape[1]
    n_seg = table.seg_voxel.shape[0]
    if (table.t_ptr.shape[0] != n_vox + 1
            or table.t_point.shape != table.t_weight.shape
            or table.t_point.shape[0] != table.idx.numel()
            or table.seg_ptr.shape[0] != n_vox + 1 or table.chunk < 1
            or n_seg != n_vox + -(-8 * n // table.chunk)
            or dout.shape[0] != n):
        raise ValueError(f"devoxelize_bwd: dout {tuple(dout.shape)} does not "
                         f"fit the transpose table of {n_vox} voxels")
    c = dout.shape[1]
    dvox = torch.empty((n_vox, c), dtype=dout.dtype, device=dev)
    # f32 rows of the segments of voxels cut in several, and the voxels'
    # arrival counters
    partial = torch.empty((n_seg, c), dtype=torch.float32, device=dev)
    counters = torch.zeros(n_vox, dtype=torch.int32, device=dev)
    cuda_lib.launch(entry, "devox_bwd", dout.data_ptr(),
                    table.t_ptr.data_ptr(), table.t_point.data_ptr(),
                    table.t_weight.data_ptr(), table.seg_ptr.data_ptr(),
                    table.seg_voxel.data_ptr(), partial.data_ptr(),
                    counters.data_ptr(), dvox.data_ptr(), n_seg, c,
                    table.chunk)
    return dvox


def devoxelize_bwd_plain(dout, table):
    cuda_lib.note_plain("devox_bwd", dout)
    return _devox_bwd(dout, table.idx, table.weights, table.num_voxels)


class DevoxFn(torch.autograd.Function):
    """point feats = devoxelize(voxel_feats, table.idx, table.weights) with
    the K8 backward; the gradient keeps the feature type."""

    @staticmethod
    def forward(ctx, voxel_feats, table):
        ctx.table = table
        return devoxelize(voxel_feats, table.idx, table.weights)

    @staticmethod
    def backward(ctx, dout):
        return devoxelize_bwd(dout, ctx.table), None
