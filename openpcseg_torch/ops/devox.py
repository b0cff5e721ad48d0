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

Both take a table of K corners a point: 8 for the trilinear tables, 4
for RPVNet's bilinear range-to-point tables (``ops/range_fusion.py``), 1
for the point-to-voxel and point-to-pixel tables. Every wrapper counts
its launches under the counter its caller names (RPVNet's range fusion
counts apart: ``r2p``, ``r2p_bwd``, ``p2r``, ``p2r_bwd``).

SPVCNN's mean-voxelize (JAX ``ops/voxelize.py voxelize_mean``, a
``segment_mean`` on XLA, no Pallas kernel) reuses both kernels over its
level's one-corner table (``core.geometry.p2v_table``: idx [1, N], the
point's voxel with weight 1): ``voxel_sum`` is K8 over it, the sum of
each voxel's points in a fixed order, so it repeats bit for bit where
``index_add_`` would not;
``point_gather``, its transpose, is K7. ``VoxelizeMeanFn`` divides by the
count around them. Their launches count apart, as ``vmean`` and
``vmean_bwd``. Cylinder3D's point-refinement head gathers each point's
level-0 voxel row (JAX: an XLA gather, whose gradient is a scatter-add):
``PointGatherFn`` is ``point_gather`` (K7) with ``voxel_sum`` (K8) as its
backward, over the level-0 p2v table, so that gradient repeats bit for bit
too.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .segment import segment_sum
from .voxelize import _devox_apply, _devox_bwd

_ENTRIES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _entry(name: str, dtype: torch.dtype) -> str:
    if dtype not in _ENTRIES:
        raise TypeError(f"{name}: no kernel for {dtype}")
    return f"opcs_{name}_{_ENTRIES[dtype]}"


def devoxelize(voxel_feats: torch.Tensor, idx: torch.Tensor,
               weights: torch.Tensor, counter: str = "devox") -> torch.Tensor:
    """point[p] = sum_c weights[c, p] * voxel_feats[idx[c, p]]: [N, C] in
    the feature type, over K = 8, 4 or 1 corners c. CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16 or f32 features,
    int32 idx, f32 weights), counted under `counter`."""
    if not voxel_feats.is_cuda:
        return devoxelize_plain(voxel_feats, idx, weights, counter)
    return _launch_devox(voxel_feats, idx, weights, counter)


def _launch_devox(voxel_feats, idx, weights, counter):
    """K7 on CUDA tensors, counted under `counter`."""
    dev = voxel_feats.device
    n = idx.shape[1]
    c = voxel_feats.shape[1]
    entry = _entry("devox", voxel_feats.dtype)
    cuda_lib.check_cuda(voxel_feats, "voxel_feats", voxel_feats.dtype, 2, dev)
    cuda_lib.check_cuda(idx, "idx", torch.int32, 2, dev)
    cuda_lib.check_cuda(weights, "weights", torch.float32, 2, dev)
    k = idx.shape[0]
    if k not in (1, 4, 8) or weights.shape != idx.shape:
        raise ValueError(f"devoxelize: idx {tuple(idx.shape)} / weights "
                         f"{tuple(weights.shape)} must both be [K, N] for "
                         f"K 8, 4 or 1")
    out = torch.empty((n, c), dtype=voxel_feats.dtype, device=dev)
    cuda_lib.launch(entry, counter, voxel_feats.data_ptr(), idx.data_ptr(),
                    weights.data_ptr(), out.data_ptr(), n, c, k)
    return out


def devoxelize_plain(voxel_feats, idx, weights, counter="devox"):
    cuda_lib.note_plain(counter, voxel_feats)
    return _devox_apply(voxel_feats, idx, weights)


def devoxelize_bwd(dout: torch.Tensor, table,
                   counter: str = "devox_bwd") -> torch.Tensor:
    """K8: dvox [V, C] in dout's type (the forward feature type) for the
    upstream gradient dout [N, C] of ``devoxelize`` over `table`
    (core.tensor.DevoxTable with its transpose and segment fields, as
    core.geometry.devox_table builds it). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise, counted under
    `counter`."""
    if not dout.is_cuda:
        return devoxelize_bwd_plain(dout, table, counter)
    return _launch_devox_bwd(dout, table, counter)


def _launch_devox_bwd(dout, table, counter):
    """K8 on CUDA tensors, counted under `counter`."""
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
            or n_seg != n_vox + -(-table.idx.numel() // table.chunk)
            or dout.shape[0] != n):
        raise ValueError(f"devoxelize_bwd: dout {tuple(dout.shape)} does not "
                         f"fit the transpose table of {n_vox} voxels")
    c = dout.shape[1]
    dvox = torch.empty((n_vox, c), dtype=dout.dtype, device=dev)
    # f32 rows of the segments of voxels cut in several, and the voxels'
    # arrival counters
    partial = torch.empty((n_seg, c), dtype=torch.float32, device=dev)
    counters = torch.zeros(n_vox, dtype=torch.int32, device=dev)
    cuda_lib.launch(entry, counter, dout.data_ptr(),
                    table.t_ptr.data_ptr(), table.t_point.data_ptr(),
                    table.t_weight.data_ptr(), table.seg_ptr.data_ptr(),
                    table.seg_voxel.data_ptr(), partial.data_ptr(),
                    counters.data_ptr(), dvox.data_ptr(), n_seg, c,
                    table.chunk)
    return dvox


def devoxelize_bwd_plain(dout, table, counter="devox_bwd"):
    cuda_lib.note_plain(counter, dout)
    return _devox_bwd(dout, table.idx, table.weights, table.num_voxels)


class DevoxFn(torch.autograd.Function):
    """point feats = devoxelize(voxel_feats, table.idx, table.weights) with
    the K8 backward; the gradient keeps the feature type. `counters` names
    the forward's and the backward's launch counters."""

    @staticmethod
    def forward(ctx, voxel_feats, table, counters=("devox", "devox_bwd")):
        ctx.table, ctx.counter = table, counters[1]
        return devoxelize(voxel_feats, table.idx, table.weights, counters[0])

    @staticmethod
    def backward(ctx, dout):
        return devoxelize_bwd(dout, ctx.table, ctx.counter), None, None


def voxel_sum(point_feats: torch.Tensor, table,
              counter: str = "vmean") -> torch.Tensor:
    """sum[v] = sum of point_feats[p] over the points p of voxel v: [V, C]
    in the feature type, over a one-corner table (core.geometry.p2v_table).
    CPU tensors take the plain version, ``segment_sum``; CUDA tensors
    launch K8 over the table or raise."""
    if not point_feats.is_cuda:
        return voxel_sum_plain(point_feats, table, counter)
    return _launch_devox_bwd(point_feats, table, counter)


def voxel_sum_plain(point_feats, table, counter="vmean"):
    cuda_lib.note_plain(counter, point_feats)
    return segment_sum(point_feats, table.idx[0], table.num_voxels)


def point_gather(voxel_feats: torch.Tensor, table,
                 counter: str = "vmean_bwd") -> torch.Tensor:
    """out[p] = voxel_feats[p's voxel], 0 for a point without one: [N, C]
    in the feature type, the transpose of ``voxel_sum``. CPU tensors take
    the plain version; CUDA tensors launch K7 over the table or raise."""
    if not voxel_feats.is_cuda:
        return point_gather_plain(voxel_feats, table, counter)
    return _launch_devox(voxel_feats.contiguous(), table.idx, table.weights,
                         counter)


def point_gather_plain(voxel_feats, table, counter="vmean_bwd"):
    cuda_lib.note_plain(counter, voxel_feats)
    p2v = table.idx[0]
    return torch.where((p2v >= 0)[:, None],
                       voxel_feats[p2v.clamp(min=0).long()], 0.0)


class VoxelizeMeanFn(torch.autograd.Function):
    """voxel means [V, C] of point feats [N, C] over a one-corner table:
    ``voxel_sum`` divided by max(count, 1) in the feature type, as JAX's
    ``segment_mean``; its backward is ``point_gather`` of dy / count, the
    gradient JAX's autodiff takes. `counters` names the sum's and the
    gather's launch counters."""

    @staticmethod
    def forward(ctx, point_feats, table, counters=("vmean", "vmean_bwd")):
        denom = table.t_ptr.diff().clamp(min=1).to(point_feats.dtype)[:, None]
        ctx.table, ctx.denom, ctx.counter = table, denom, counters[1]
        return voxel_sum(point_feats, table, counters[0]) / denom

    @staticmethod
    def backward(ctx, dy):
        return point_gather(dy / ctx.denom, ctx.table, ctx.counter), None, None


class PointGatherFn(torch.autograd.Function):
    """out[p] = voxel_feats[p's voxel] (0 without one) over a one-corner
    table; its backward sums each voxel's point gradients (``voxel_sum``)."""

    @staticmethod
    def forward(ctx, voxel_feats, table):
        ctx.table = table
        return point_gather(voxel_feats, table)

    @staticmethod
    def backward(ctx, dout):
        return voxel_sum(dout, ctx.table), None
