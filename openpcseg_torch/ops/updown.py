"""k2/s2 strided (down) and transposed (up) convs: wrappers of K3-K6.

Counterpart of ``openpcseg_tpu/ops/pallas_updown.py``:

- K3 replaces ``_pair_kernel`` (want_dw=False, entry ``pallas_conv_down2``):
  ``coarse[c] = sum_{k<8} fine[down_kmap[k,c]] @ W[k]``. It is the K = 8 case
  of the gather-GEMM in ``csrc/gather_gemm.cu``; plain version
  ``ops.sparse_conv._conv_apply``.
- K4 replaces ``_parent_kernel`` (want_dw=False, entry ``pallas_conv_up2``):
  ``fine[f] = coarse[parent(f)] @ W[parity(f)]`` in ``csrc/parent_gemm.cu``,
  tiled by the coarse level's parity plan (``core.tensor.ParityPlan``,
  built once per step in ``build_pyramid``); plain version
  ``ops.sparse_conv._up2_fwd_impl`` over the up map.
- K6 replaces ``_parent_kernel`` (want_dw=True, the down backward
  ``_down2_bwd``): ``dfeats_f[i] = dout[parent(i)] @ W[parity(i)]^T`` is
  K4's parent gather over the same parity plan with ``W^T``, and dW is
  ``csrc/gather_dw.cu`` with the fine feats gathered by the down map;
  plain version ``ops.sparse_conv._core_bwd`` over the up map.
- K5 replaces ``_pair_kernel`` (want_dw=True, the up backward
  ``_up2_bwd_pl``): ``dfeats_c[o] = sum_k dout[down_kmap[k,o]] @ W[k]^T``
  is the K = 8 gather-GEMM over the coarse level's down map with ``W^T``,
  and dW is ``gather_dw`` with the fine dout gathered by that map; plain
  version ``ops.sparse_conv._core_bwd`` over that map (JAX ``_up2_bwd``).

The TPU kernels fuse dfeats and dW over one gathered tile; here each
backward is two launches (fusing them is later speed work, ROADMAP.md).
"""
from __future__ import annotations

import torch

from ..core.tensor import ParityPlan
from . import cuda_lib
from .sparse_conv import _conv_apply, _core_bwd, _up2_fwd_impl
from .subm_conv import gather_dw, gather_gemm


def down_conv(feats: torch.Tensor, weights: torch.Tensor,
              kmap: torch.Tensor) -> torch.Tensor:
    """Strided conv fine -> coarse over the down map [8, N_coarse]:
    float32 [N_coarse, Cout]. CPU: plain version; CUDA: K3 or raise."""
    if not feats.is_cuda:
        return down_conv_plain(feats, weights, kmap)
    return gather_gemm(feats, weights, kmap, "down")


def down_conv_plain(feats, weights, kmap):
    cuda_lib.note_plain("down", feats)
    return _conv_apply(feats, weights, kmap, None, feats.dtype)


def parent_gemm(src: torch.Tensor, weights: torch.Tensor, plan: ParityPlan,
                counter: str) -> torch.Tensor:
    """Launch the parent gather over a level's parity plan: out[f] =
    src[parent f] @ W[parity f], zero rows where f has no parent, float32
    [N_fine, Cout]. bf16 src; weights are cast to bf16."""
    dev = src.device
    k, cin, cout = weights.shape
    w = weights.to(torch.bfloat16).contiguous()
    cuda_lib.check_cuda(src, "src", torch.bfloat16, 2, dev)
    cuda_lib.check_cuda(w, "weights", torch.bfloat16, 3, dev)
    for name in ("src_rows", "dst_rows", "group_offsets", "tile_offsets"):
        cuda_lib.check_cuda(getattr(plan, name), name, torch.int32, 1, dev)
    n_out = plan.dst_rows.shape[0]
    if (k != 8 or src.shape[1] != cin or plan.src_rows.shape[0] != n_out
            or plan.group_offsets.shape[0] != 10
            or plan.tile_offsets.shape[0] != 10):
        raise ValueError(f"parent_gemm: src {tuple(src.shape)}, weights "
                         f"{tuple(weights.shape)}, plan of {n_out} rows")
    out = torch.empty((n_out, cout), dtype=torch.float32, device=dev)
    cuda_lib.launch("opcs_parent_gemm_bf16", counter, src.data_ptr(),
                    w.data_ptr(), plan.src_rows.data_ptr(),
                    plan.dst_rows.data_ptr(), plan.group_offsets.data_ptr(),
                    plan.tile_offsets.data_ptr(), out.data_ptr(), cin, cout,
                    plan.max_tiles, plan.tile_rows)
    return out


def up_conv(feats: torch.Tensor, weights: torch.Tensor,
            up_kmap: torch.Tensor, plan: ParityPlan) -> torch.Tensor:
    """Transposed conv coarse -> fine over a one-hot up map [8, N_fine]:
    float32 [N_fine, Cout]. CPU: plain version over the map; CUDA: K4 over
    the coarse level's parity plan (the same pairs), or raise."""
    if not feats.is_cuda:
        return up_conv_plain(feats, weights, up_kmap)
    return parent_gemm(feats, weights, plan, "up")


def up_conv_plain(feats, weights, up_kmap):
    cuda_lib.note_plain("up", feats)
    return _up2_fwd_impl(feats, weights, up_kmap, feats.dtype)


def down_conv_bwd(dout: torch.Tensor, feats: torch.Tensor,
                  weights: torch.Tensor, kmap: torch.Tensor,
                  up_kmap: torch.Tensor, plan: ParityPlan):
    """K6: (dfeats [N_fine, Cin], dW [8, Cin, Cout]), both float32, for
    the upstream gradient dout [N_coarse, Cout] of ``down_conv`` over the
    down map `kmap`; `up_kmap` is the fine level's up map (the transpose)
    and `plan` the coarse level's parity plan (the same pairs). CPU: plain
    version over the maps; CUDA: the kernels or raise."""
    if not dout.is_cuda:
        return down_conv_bwd_plain(dout, feats, weights, kmap, up_kmap)
    d16 = dout.to(torch.bfloat16).contiguous()
    dfeats = parent_gemm(d16, weights.transpose(1, 2), plan, "down_bwd")
    return dfeats, gather_dw(feats, kmap, d16, None)


def down_conv_bwd_plain(dout, feats, weights, kmap, up_kmap):
    cuda_lib.note_plain("down_bwd", dout)
    return _core_bwd(feats, weights, up_kmap, dout, None, feats.dtype)


def up_conv_bwd(dout: torch.Tensor, feats: torch.Tensor,
                weights: torch.Tensor, up_kmap: torch.Tensor,
                down_kmap: torch.Tensor):
    """K5: (dfeats [N_coarse, Cin], dW [8, Cin, Cout]), both float32, for
    the upstream gradient dout [N_fine, Cout] of ``up_conv``; `down_kmap`
    is the coarse level's down map (the transpose of `up_kmap`).
    CPU: plain version; CUDA: the kernels or raise."""
    if not dout.is_cuda:
        return up_conv_bwd_plain(dout, feats, weights, up_kmap, down_kmap)
    d16 = dout.to(torch.bfloat16).contiguous()
    dfeats = gather_gemm(d16, weights.transpose(1, 2), down_kmap, "up_bwd")
    return dfeats, gather_dw(feats, None, d16, down_kmap)


def up_conv_bwd_plain(dout, feats, weights, up_kmap, down_kmap):
    cuda_lib.note_plain("up_bwd", dout)
    return _core_bwd(feats, weights, down_kmap, dout, None, feats.dtype)


class DownConvFn(torch.autograd.Function):
    """out = down_conv(feats, W, down_kmap) with the K6 backward, which
    needs the fine level's up map and the coarse level's parity plan.
    Returns float32."""

    @staticmethod
    def forward(ctx, feats, weights, kmap, up_kmap, plan):
        ctx.save_for_backward(feats, weights, kmap, up_kmap)
        ctx.plan = plan
        return down_conv(feats, weights, kmap)

    @staticmethod
    def backward(ctx, dout):
        feats, weights, kmap, up_kmap = ctx.saved_tensors
        dfeats, dw = down_conv_bwd(dout, feats, weights, kmap, up_kmap,
                                   ctx.plan)
        return dfeats.to(feats.dtype), dw.to(weights.dtype), None, None, None


class UpConvFn(torch.autograd.Function):
    """out = up_conv(feats, W, up_kmap, plan) with the K5 backward, which
    needs the coarse level's down map. Returns float32."""

    @staticmethod
    def forward(ctx, feats, weights, up_kmap, down_kmap, plan):
        ctx.save_for_backward(feats, weights, up_kmap, down_kmap)
        return up_conv(feats, weights, up_kmap, plan)

    @staticmethod
    def backward(ctx, dout):
        feats, weights, up_kmap, down_kmap = ctx.saved_tensors
        dfeats, dw = up_conv_bwd(dout, feats, weights, up_kmap, down_kmap)
        return dfeats.to(feats.dtype), dw.to(weights.dtype), None, None, None
