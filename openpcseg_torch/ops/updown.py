"""k2/s2 strided (down) and transposed (up) convs: wrappers of K3 and K4.

Counterpart of ``openpcseg_tpu/ops/pallas_updown.py``, forward only:

- K3 replaces ``_pair_kernel`` (want_dw=False, entry ``pallas_conv_down2``):
  ``coarse[c] = sum_{k<8} fine[down_kmap[k,c]] @ W[k]``. It is the K = 8 case
  of the gather-GEMM in ``csrc/gather_gemm.cu``; plain version
  ``ops.sparse_conv._conv_apply``.
- K4 replaces ``_parent_kernel`` (want_dw=False, entry ``pallas_conv_up2``):
  ``fine[f] = coarse[parent(f)] @ W[parity(f)]`` in ``csrc/parent_gemm.cu``;
  plain version ``ops.sparse_conv._up2_fwd_impl``.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .sparse_conv import _conv_apply, _up2_fwd_impl
from .subm_conv import gather_gemm


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


def parent_parity(up_kmap: torch.Tensor):
    """(parent [N_fine], parity [N_fine]) int32 of a one-hot up map: the
    single hit per row and its offset (parent -1 where a row has none)."""
    parent = up_kmap.max(dim=0).values.to(torch.int32).contiguous()
    parity = (up_kmap >= 0).to(torch.int32).argmax(dim=0)
    return parent, parity.to(torch.int32).contiguous()


def up_conv(feats: torch.Tensor, weights: torch.Tensor,
            up_kmap: torch.Tensor) -> torch.Tensor:
    """Transposed conv coarse -> fine over a one-hot up map [8, N_fine]:
    float32 [N_fine, Cout]. CPU: plain version; CUDA: K4 or raise."""
    if not feats.is_cuda:
        return up_conv_plain(feats, weights, up_kmap)
    dev = feats.device
    k, cin, cout = weights.shape
    w = weights.to(torch.bfloat16).contiguous()
    cuda_lib.check_cuda(feats, "feats", torch.bfloat16, 2, dev)
    cuda_lib.check_cuda(up_kmap, "up_kmap", torch.int32, 2, dev)
    if k != 8 or feats.shape[1] != cin or up_kmap.shape[0] != 8:
        raise ValueError(f"up_conv: feats {tuple(feats.shape)}, weights "
                         f"{tuple(weights.shape)}, kmap {tuple(up_kmap.shape)}")
    parent, parity = parent_parity(up_kmap)
    n_out = up_kmap.shape[1]
    out = torch.empty((n_out, cout), dtype=torch.float32, device=dev)
    cuda_lib.launch("opcs_parent_gemm_bf16", "up", feats.data_ptr(),
                    w.data_ptr(), parent.data_ptr(), parity.data_ptr(),
                    out.data_ptr(), n_out, cin, cout)
    return out


def up_conv_plain(feats, weights, up_kmap):
    cuda_lib.note_plain("up", feats)
    return _up2_fwd_impl(feats, weights, up_kmap, feats.dtype)
