"""3x3x3 submanifold sparse conv: the wrappers of kernels K1 and K2.

Counterpart of ``openpcseg_tpu/ops/pallas_conv.py``:

- K1, the forward kernel ``_fwd_kernel`` (entry ``pallas_window_subm_conv``),
  is replaced by the gather-GEMM in ``csrc/gather_gemm.cu``; its plain
  version is ``ops.sparse_conv._conv_apply`` with the identity centre.
- K2, the fused backward kernel ``_bwd_kernel`` (via ``_run_bwd`` from
  ``_core_bwd``), becomes two launches: dfeats is K1's gather-GEMM over the
  offset-reversed map ``kmap.flip(0)`` with ``W[k]^T`` (``kmap_t[k] =
  kmap[K-1-k]`` pairs with ``W[k]^T``, not ``W[K-1-k]^T``), and dW is the
  gathered weight gradient of ``csrc/gather_dw.cu``. Its plain version is
  ``ops.sparse_conv._core_bwd``.

``SubmConvFn`` is the autograd Function over both. The sources say what
bounds each kernel on the H100 and what the design does about it. Unlike
the JAX dispatch (``layers.py:131-139``), the 4-channel stem conv takes the
kernels too: they mask the ragged Cin edge.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import cuda_lib
from .sparse_conv import _acc, _conv_apply, _core_bwd, _gather_rows

# gather_dw grid sizing: enough blocks to fill the card's 132 SMs several
# times over, a bounded float32 partial buffer, and at least 256 rows per
# chunk (at L3 384->256 with K = 27 one chunk of partials is 10.6 MB)
DW_TARGET_BLOCKS = 132 * 8
DW_PARTIAL_BYTES = 64 << 20
DW_MIN_ROWS = 256


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


def dw_chunks(n: int, num_k: int, ca: int, cb: int):
    """(rows_per_chunk, n_chunks) of the gather_dw reduction over n rows."""
    tiles = math.ceil(ca / 64) * math.ceil(cb / 64)
    want = math.ceil(DW_TARGET_BLOCKS / (num_k * tiles))
    cap = DW_PARTIAL_BYTES // (num_k * ca * cb * 4)
    n_chunks = max(1, min(want, cap, n // DW_MIN_ROWS))
    rows = math.ceil(n / n_chunks / 32) * 32
    return rows, math.ceil(n / rows)


def gather_dw(a: torch.Tensor, ia: Optional[torch.Tensor], b: torch.Tensor,
              ib: Optional[torch.Tensor]) -> torch.Tensor:
    """dW[k] = sum_n a[ia[k,n]]^T b[ib[k,n]] -> float32 [K, Ca, Cb].

    ia / ib are [K, n] int32 maps (-1 drops the pair) or None for the
    identity (then that side has n rows). bf16 a and b. CPU tensors take
    the plain version; CUDA tensors launch csrc/gather_dw.cu or raise."""
    if not a.is_cuda:
        return gather_dw_plain(a, ia, b, ib)
    dev = a.device
    idx = ia if ia is not None else ib
    if idx is None:
        raise ValueError("gather_dw: at least one side needs a map")
    num_k, n = idx.shape
    for name, x, m in (("a", a, ia), ("b", b, ib)):
        cuda_lib.check_cuda(x, name, torch.bfloat16, 2, dev)
        if m is not None:
            cuda_lib.check_cuda(m, f"i{name}", torch.int32, 2, dev)
            if tuple(m.shape) != (num_k, n):
                raise ValueError(f"gather_dw: i{name} {tuple(m.shape)}, "
                                 f"expected {(num_k, n)}")
        elif x.shape[0] != n:
            raise ValueError(f"gather_dw: identity side {name} has "
                             f"{x.shape[0]} rows, the map {n}")
    ca, cb = a.shape[1], b.shape[1]
    rows, n_chunks = dw_chunks(n, num_k, ca, cb)
    out = torch.empty((num_k, ca, cb), dtype=torch.float32, device=dev)
    partial = (torch.empty((n_chunks, num_k, ca, cb), dtype=torch.float32,
                           device=dev) if n_chunks > 1 else None)
    cuda_lib.launch(
        "opcs_gather_dw_bf16", "dw", a.data_ptr(),
        None if ia is None else ia.data_ptr(), b.data_ptr(),
        None if ib is None else ib.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(), n,
        num_k, ca, cb, rows, n_chunks)
    return out


def gather_dw_plain(a, ia, b, ib):
    cuda_lib.note_plain("dw", a)
    idx = ia if ia is not None else ib
    acc = _acc(a.dtype)

    def side(x, m, k):
        return x[:idx.shape[1]] if m is None else _gather_rows(x, m[k], x.dtype)
    return torch.stack([side(a, ia, k).to(acc).t() @ side(b, ib, k).to(acc)
                        for k in range(idx.shape[0])])


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


def subm_conv_bwd(dout: torch.Tensor, feats: torch.Tensor,
                  weights: torch.Tensor, kmap: torch.Tensor,
                  need_dfeats: bool = True):
    """K2: (dfeats [N, Cin] or None, dW [27, Cin, Cout]), both float32,
    for the upstream gradient dout [N, Cout] of ``subm_conv``. CPU tensors
    take the plain version; CUDA tensors launch the kernels or raise."""
    if not dout.is_cuda:
        return subm_conv_bwd_plain(dout, feats, weights, kmap, need_dfeats)
    d16 = dout.to(torch.bfloat16).contiguous()
    dfeats = None
    if need_dfeats:
        dfeats = gather_gemm(d16, weights.transpose(1, 2), kmap.flip(0),
                             "subm_bwd")
    return dfeats, gather_dw(feats, kmap, d16, None)


def subm_conv_bwd_plain(dout, feats, weights, kmap, need_dfeats=True):
    cuda_lib.note_plain("subm_bwd", dout)
    dfeats, dw = _core_bwd(feats, weights, kmap.flip(0), dout,
                           weights.shape[0] // 2, feats.dtype)
    return (dfeats if need_dfeats else None), dw


class SubmConvFn(torch.autograd.Function):
    """out = subm_conv(feats, W, kmap) with the K2 backward. Returns
    float32; dfeats comes back in the feats type, dW in the weight type
    (the JAX custom VJP casts the same way)."""

    @staticmethod
    def forward(ctx, feats, weights, kmap):
        ctx.save_for_backward(feats, weights, kmap)
        return subm_conv(feats, weights, kmap)

    @staticmethod
    def backward(ctx, dout):
        feats, weights, kmap = ctx.saved_tensors
        dfeats, dw = subm_conv_bwd(dout, feats, weights, kmap,
                                   ctx.needs_input_grad[0])
        if dfeats is not None:
            dfeats = dfeats.to(feats.dtype)
        return dfeats, dw.to(weights.dtype), None
