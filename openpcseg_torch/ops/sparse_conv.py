"""Sparse 3D convolution as gather + matmul: the plain versions.

Counterpart of ``openpcseg_tpu/ops/sparse_conv.py``. With a dense kernel
map ``idx[K, N_out]`` (-1 = miss)

    out[n] = sum_k  feats[kmap[k, n]] @ W[k]

is K row gathers and K matmuls. ``_conv_apply`` is the plain version of the
gather-GEMM kernels K1 (submanifold) and K3 (strided down);
``_up2_fwd_impl`` is the plain version of the parent-gather kernel K4
(transposed up). Operands are cast to the compute type and multiplied in
float32, which is JAX's ``preferred_element_type=float32`` accumulation
(float64 operands stay float64, for ``torch.autograd.gradcheck``).
``sparse_conv_1x1`` stays a plain matmul, as JAX leaves it to XLA.

The backward is scatter-free, as in JAX: the data gradient of a sparse conv
is the same conv over the transposed map,

    dfeats[i] = sum_k  dout[kmap_t[k, i]] @ W[k]^T,   dW[k] = feats^T @ g_t[k]

with ``g_t[k] = dout[kmap_t[k]]`` (masked). ``_core_bwd`` is the plain
version of the backward kernels K2 (submanifold, ``kmap_t = flip(kmap)``),
K6 (down, ``kmap_t`` = the fine level's up map) and K5 (up, ``kmap_t`` = the
coarse level's down map: JAX's ``_up2_bwd`` is ``_core_bwd`` without a
centre offset).
"""
from __future__ import annotations

from typing import Optional

import torch


def _acc(cdt: torch.dtype) -> torch.dtype:
    """The accumulation type of compute type `cdt`: float32, or float64
    for float64 operands."""
    return torch.float64 if cdt == torch.float64 else torch.float32


def _mm(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """a @ b with operands rounded to `cdt`, accumulated in float32."""
    acc = _acc(cdt)
    return a.to(cdt).to(acc) @ b.to(cdt).to(acc)


def _gather_rows(x: torch.Tensor, idx_row: torch.Tensor,
                 cdt: torch.dtype) -> torch.Tensor:
    """Masked row gather: idx -1 -> zero row. [N] int32 -> [N, C]."""
    g = x[idx_row.clamp(min=0).long()].to(cdt)
    return torch.where((idx_row >= 0)[:, None], g, torch.zeros_like(g))


def _conv_apply(feats: torch.Tensor, weights: torch.Tensor,
                kmap: torch.Tensor, center: Optional[int],
                cdt: torch.dtype) -> torch.Tensor:
    """out[n] = sum_k feats[kmap[k,n]] @ W[k] -> [N_out, Cout] float32.
    `center` names an identity offset computed without a gather."""
    n_out = kmap.shape[1]
    out = (_mm(feats, weights[center], cdt) if center is not None else
           torch.zeros((n_out, weights.shape[2]), dtype=_acc(cdt),
                       device=feats.device))
    for k in range(kmap.shape[0]):
        if k != center:
            out = out + _mm(_gather_rows(feats, kmap[k], cdt), weights[k], cdt)
    return out


def _up2_fwd_impl(feats: torch.Tensor, weights: torch.Tensor,
                  kmap: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """k2/s2 transposed conv with one matched (parent, offset) pair per
    output: T = feats @ [W_0 .. W_7] (rounded to `cdt`), out[f] =
    T[parent(f), parity(f)] -> [N_fine, Cout] float32."""
    k, cin, cout = weights.shape
    nc = feats.shape[0]
    w_all = weights.permute(1, 0, 2).reshape(cin, k * cout)
    t_flat = _mm(feats, w_all, cdt).reshape(nc * k, cout).to(cdt)
    offs = torch.arange(k, dtype=kmap.dtype, device=kmap.device)[:, None]
    idx = torch.where(kmap >= 0, kmap * k + offs,
                      torch.full_like(kmap, -1)).max(dim=0).values
    g = t_flat[idx.clamp(min=0).long()].to(_acc(cdt))
    return torch.where((idx >= 0)[:, None], g, torch.zeros_like(g))


def _core_bwd(feats: torch.Tensor, weights: torch.Tensor,
              kmap_t: torch.Tensor, dout: torch.Tensor,
              center: Optional[int], cdt: torch.dtype):
    """Backward of ``_conv_apply`` over the transposed map kmap_t [K, N_in]
    -> (dfeats [N_in, Cin], dW [K, Cin, Cout]), both float32.

    One gathered dout block per offset serves both gradients; `center`
    names an identity offset of kmap_t, taken without a gather (JAX
    ``ops/sparse_conv.py _core_bwd``)."""
    k, cin, cout = weights.shape
    w_t = weights.transpose(1, 2)                    # [K, Cout, Cin]
    fc_t = feats.t()
    dfeats = (_mm(dout, w_t[center], cdt) if center is not None else
              torch.zeros((kmap_t.shape[1], cin), dtype=_acc(cdt),
                          device=dout.device))
    dws = []
    for i in range(k):
        g_t = dout if i == center else _gather_rows(dout, kmap_t[i], cdt)
        if i != center:
            dfeats = dfeats + _mm(g_t, w_t[i], cdt)
        dws.append(_mm(fc_t, g_t, cdt))
    return dfeats, torch.stack(dws)


def sparse_conv_1x1(feats: torch.Tensor, weights: torch.Tensor,
                    out_valid: torch.Tensor, *,
                    compute_dtype: torch.dtype) -> torch.Tensor:
    """1x1x1 sparse conv = per-voxel matmul, masked, in the promoted type."""
    out = torch.where(out_valid[:, None], _mm(feats, weights, compute_dtype),
                      0.0)
    return out.to(torch.promote_types(feats.dtype, compute_dtype))
