"""3x3x3 submanifold sparse conv: the wrappers of kernels K1 and K2.

Counterpart of ``openpcseg_tpu/ops/pallas_conv.py``:

- K1, the forward kernel ``_fwd_kernel`` (entry ``pallas_window_subm_conv``),
  is replaced by the gather-GEMM in ``csrc/gather_gemm.cu``; its plain
  version is ``ops.sparse_conv._conv_apply`` with the identity centre.
- K2, the fused backward kernel ``_bwd_kernel`` (via ``_run_bwd`` from
  ``_core_bwd``), becomes two launches: dfeats is K1's gather-GEMM over the
  offset-reversed map with ``W[k]^T`` (``kmap_t[k] = kmap[K-1-k]`` pairs
  with ``W[k]^T``, not ``W[K-1-k]^T``; the kernel reads the map reversed,
  so no flipped copy is made), and dW is the gathered weight gradient of
  ``csrc/gather_dw.cu``. Its plain version is ``ops.sparse_conv._core_bwd``
  over ``kmap.flip(0)``.

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

# gather_dw grid sizing: the blocks' work is uneven (the submanifold map's
# centre offset pairs every row, the others a fifth to a third of them, and
# the padding rows none), so the grid aims at eight waves of two blocks on
# each of the card's 132 SMs; the float32 partials, written and read once
# more, are held to 64 MB for the 27-offset maps and 20 MB for the 8-offset
# ones, whose blocks have less work to spread; and a chunk has at least 256
# rows. (Chosen by sweeping the chunk count on the H100 at the main-path
# shapes: fewer chunks leave the long blocks alone on the card, more spend
# the time on partials.)
DW_TARGET_BLOCKS = 132 * 2 * 8
DW_MIN_ROWS = 256


def dw_partial_bytes(num_k: int) -> int:
    return (64 << 20) if num_k > 8 else (20 << 20)


# gather-GEMM split over offsets: on the small levels (fewer than 256 row
# tiles of 128, where csrc/gather_gemm.cu takes 64-row tiles) few tiles
# carry voxels while each walks its K offsets x Cin channels in series, so
# a tile's live offsets are divided among up to GEMM_MAX_SPLITS blocks, one
# per GEMM_SPLIT_WORK offset-channels
GEMM_MAX_SPLITS = 4
GEMM_SPLIT_WORK = 2048


def gemm_splits(n_out: int, num_k: int, cin: int) -> int:
    """Blocks that share one output tile of the gather-GEMM (its `splits`
    argument), from the shapes alone."""
    if math.ceil(n_out / 128) >= 256:
        return 1
    return min(GEMM_MAX_SPLITS, math.ceil(num_k * cin / GEMM_SPLIT_WORK))


def gather_gemm(feats: torch.Tensor, weights: torch.Tensor,
                kmap: torch.Tensor, counter: str,
                reverse: bool = False) -> torch.Tensor:
    """Launch the gather-GEMM: out[n] = sum_k feats[kmap[k',n]] @ W[k],
    float32 [N_out, Cout], with k' = k, or K-1-k where `reverse` is set.
    bf16 feats; weights are cast to bf16."""
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
    splits = gemm_splits(n_out, k, cin)
    partial = counters = None
    if splits > 1:
        partial = torch.empty((splits, n_out, cout), dtype=torch.float32,
                              device=dev)
        counters = torch.zeros(math.ceil(n_out / 64) * math.ceil(cout / 32),
                               dtype=torch.int32, device=dev)
    cuda_lib.launch("opcs_gather_gemm_bf16", counter, feats.data_ptr(),
                    w.data_ptr(), kmap.data_ptr(), out.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    None if counters is None else counters.data_ptr(), n_out,
                    k, cin, cout, int(reverse), splits)
    return out


def dw_tile(ca: int, cb: int):
    """(TM, TN) of the gather_dw block for widths (Ca, Cb), as
    csrc/gather_dw.cu launch_of picks it: TM = 32..128, TN = 64 or 128."""
    return 32 * min(math.ceil(ca / 32), 4), 64 * min(math.ceil(cb / 64), 2)


def dw_chunks(n: int, num_k: int, ca: int, cb: int):
    """(rows_per_chunk, n_chunks) of the gather_dw reduction over n rows."""
    tm, tn = dw_tile(ca, cb)
    tiles = math.ceil(ca / tm) * math.ceil(cb / tn)
    want = math.ceil(DW_TARGET_BLOCKS / (num_k * tiles))
    cap = dw_partial_bytes(num_k) // (num_k * ca * cb * 4)
    n_chunks = max(1, min(want, cap, n // DW_MIN_ROWS))
    rows = math.ceil(n / n_chunks / 32) * 32
    return rows, math.ceil(n / rows)


def gather_dw(a: torch.Tensor, ia: Optional[torch.Tensor], b: torch.Tensor,
              ib: Optional[torch.Tensor], counter: str = "dw") -> torch.Tensor:
    """dW[k] = sum_n a[ia[k,n]]^T b[ib[k,n]] -> float32 [K, Ca, Cb].

    ia / ib are [K, n] int32 maps (-1 drops the pair) or None for the
    identity (then that side has n rows). bf16 a and b. CPU tensors take
    the plain version; CUDA tensors launch csrc/gather_dw.cu, counted under
    `counter`, or raise."""
    if not a.is_cuda:
        return gather_dw_plain(a, ia, b, ib, counter)
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
        "opcs_gather_dw_bf16", counter, a.data_ptr(),
        None if ia is None else ia.data_ptr(), b.data_ptr(),
        None if ib is None else ib.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(), n,
        num_k, ca, cb, rows, n_chunks)
    return out


def gather_dw_plain(a, ia, b, ib, counter="dw"):
    cuda_lib.note_plain(counter, a)
    idx = ia if ia is not None else ib
    acc = _acc(a.dtype)

    def side(x, m, k):
        return x[:idx.shape[1]] if m is None else _gather_rows(x, m[k], x.dtype)
    return torch.stack([side(a, ia, k).to(acc).t() @ side(b, ib, k).to(acc)
                        for k in range(idx.shape[0])])


def subm_conv(feats: torch.Tensor, weights: torch.Tensor,
              kmap: torch.Tensor) -> torch.Tensor:
    """Submanifold conv over kmap [K, N] of a centred odd box (the 3^3 map,
    or an anisotropic kernel's rows of it, ``ops.kmap.subm_subset_indices``;
    centre row K // 2 = identity, -1 on padding rows): float32 [N, Cout]. Padding rows of `feats` must be zero,
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
    """K2: (dfeats [N, Cin] or None, dW [K, Cin, Cout]), both float32,
    for the upstream gradient dout [N, Cout] of ``subm_conv``. The map read
    reversed is the transposed map because a centred odd box's offsets
    reversed are their negations. CPU tensors
    take the plain version; CUDA tensors launch the kernels or raise."""
    if not dout.is_cuda:
        return subm_conv_bwd_plain(dout, feats, weights, kmap, need_dfeats)
    d16 = dout.to(torch.bfloat16).contiguous()
    dfeats = None
    if need_dfeats:
        dfeats = gather_gemm(d16, weights.transpose(1, 2), kmap, "subm_bwd",
                             reverse=True)
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
