"""3x3x3 submanifold sparse conv: the wrapper of kernel K1.

Counterpart of ``openpcseg_tpu/ops/pallas_conv.py``; its forward kernel
``_fwd_kernel`` (entry ``pallas_window_subm_conv``) is replaced by the
gather-GEMM in ``csrc/gather_gemm.cu`` (the source says what bounds it on
the H100 and what the design does about it). The plain version is
``ops.sparse_conv._conv_apply`` with the identity centre offset.

Unlike the JAX dispatch (``layers.py:131-139``), the 4-channel stem conv
takes the kernel too: the kernel masks its ragged Cin edge.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .sparse_conv import _conv_apply


def gather_gemm(feats: torch.Tensor, weights: torch.Tensor,
                kmap: torch.Tensor, counter: str) -> torch.Tensor:
    """Launch the gather-GEMM: out[n] = sum_k feats[kmap[k,n]] @ W[k],
    float32 [N_out, Cout]. bf16 feats; weights are cast to bf16."""
    dev = feats.device
    k, cin, cout = weights.shape
    w = weights.to(torch.bfloat16).contiguous()
    cuda_lib.check_cuda(feats, "feats", torch.bfloat16, 2, dev)
    cuda_lib.check_cuda(w, "weights", torch.bfloat16, 3, dev)
    cuda_lib.check_cuda(kmap, "kmap", torch.int32, 2, dev)
    if feats.shape[1] != cin or kmap.shape[0] != k:
        raise ValueError(f"gather_gemm: feats {tuple(feats.shape)}, weights "
                         f"{tuple(weights.shape)}, kmap {tuple(kmap.shape)}")
    n_out = kmap.shape[1]
    out = torch.empty((n_out, cout), dtype=torch.float32, device=dev)
    cuda_lib.launch("opcs_gather_gemm_bf16", counter, feats.data_ptr(),
                    w.data_ptr(), kmap.data_ptr(), out.data_ptr(), n_out, k,
                    cin, cout)
    return out


def subm_conv(feats: torch.Tensor, weights: torch.Tensor,
              kmap: torch.Tensor) -> torch.Tensor:
    """Submanifold conv over kmap [27, N] (centre row = identity, -1 on
    padding rows): float32 [N, Cout]. Padding rows of `feats` must be zero,
    as everywhere in the package: the plain version multiplies the centre
    offset without a gather. CPU tensors take the plain version; CUDA
    tensors launch K1 or raise."""
    if not feats.is_cuda:
        return subm_conv_plain(feats, weights, kmap)
    return gather_gemm(feats, weights, kmap, "subm")


def subm_conv_plain(feats, weights, kmap):
    cuda_lib.note_plain("subm", feats)
    return _conv_apply(feats, weights, kmap, weights.shape[0] // 2,
                       feats.dtype)
