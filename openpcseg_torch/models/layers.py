"""Sparse network building blocks (torch.nn).

Counterpart of ``openpcseg_tpu/models/layers.py``: SparseConv,
MaskedBatchNorm, BasicConvBlock, ResidualBlock, Bottleneck,
``repeated_blocks`` and dropout. Layers take their kernel maps and
validity masks from a precomputed VoxelPyramid; they never build
geometry themselves. BN uses batch statistics while the module is
training (``module.train()``) and running statistics otherwise.

Conv dispatch (the port's rewrite of ``layers.py:116-148``): each conv
names its kind, and each kind has one autograd Function whose forward and
backward wrappers run their plain versions for a CPU tensor and their
Hopper kernels for a CUDA tensor, for every Cin (the JAX package keeps
Cin < 16 on XLA):

    "subm" (submanifold, 3x3x3 or an anisotropic centred odd box)
                               -> ops.subm_conv.SubmConvFn (K1, K2)
    "down" (k2/s2 strided)     -> ops.updown.DownConvFn    (K3, K6)
    "up"   (k2/s2 transposed)  -> ops.updown.UpConvFn      (K4, K5)
    "strided" (k3 strided or transposed, any stride)
                               -> ops.updown.StridedConvFn (the gather-GEMM
                                  and gather_dw: Cylinder3D's pools and up
                                  convs, XLA convs in JAX)
    1x1x1                      -> ops.sparse_conv.sparse_conv_1x1 (matmul)

An anisotropic submanifold conv (Cylinder3D's (1, 3, 3), (3, 1, 1), ...)
takes its rows of the level's 3^3 map (``SparseLevel.subm_subset``); in
JAX it runs on XLA (``window_subm_conv``), here on K1 / K2 like the 3^3
convs. The strided and transposed kinds carry the transposed map their
backward needs (``kmap_t``): a down conv the fine level's up map, an up
conv the coarse level's down map; the submanifold kind reverses its own
map. The k2/s2 kinds also carry the coarse level's parity plan
(``plan``), which the parent gather of the up conv (K4) and of the down
backward (K6) tiles by. ``bias=True`` adds a zero-initialised bias on the
valid rows (JAX ``use_bias``).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from ..core.tensor import ParityPlan
from ..ops.kmap import kernel_offsets
from ..ops.sparse_conv import sparse_conv_1x1
from ..ops.subm_conv import SubmConvFn
from ..ops.updown import DownConvFn, StridedConvFn, UpConvFn
from ..parallel.ddp import all_reduce_sum

# kind -> (kernel size, autograd Function)
_CONVS = {"subm": (3, SubmConvFn), "down": (2, DownConvFn),
          "up": (2, UpConvFn), "strided": (3, StridedConvFn)}

# flax variance_scaling(1.0, "fan_in", "truncated_normal"): the std of a
# unit normal truncated to [-2, 2] is 0.87962566...
_TRUNC_STD = 0.87962566103423978
# EMA decay of the BN running statistics (torch momentum 0.1)
_BN_DECAY = 0.9


class SparseConv(nn.Module):
    """Sparse convolution over a precomputed kernel map. weight is
    [K, Cin, Cout] in ``ops.kmap.kernel_offsets(kernel_size)`` order
    ([Cin, Cout] for the 1x1 kind); it returns the masked output in the
    promoted type, plus the bias on valid rows where ``bias``."""

    def __init__(self, cin: int, cout: int, kind: str = "subm",
                 compute_dtype: torch.dtype = torch.float32,
                 kernel_size=None, bias: bool = False):
        super().__init__()
        if kind != "1x1" and kind not in _CONVS:
            raise ValueError(f"unknown conv kind {kind!r}")
        self.kind = kind
        self.compute_dtype = compute_dtype
        self.kernel_size = (1 if kind == "1x1" else kernel_size
                            or _CONVS[kind][0])
        k = len(kernel_offsets(self.kernel_size))
        shape = (cin, cout) if kind == "1x1" else (k, cin, cout)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.fan_in = k * cin

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, feats: torch.Tensor, kmap: Optional[torch.Tensor],
                out_valid: torch.Tensor,
                kmap_t: Optional[torch.Tensor] = None,
                plan: Optional[ParityPlan] = None) -> torch.Tensor:
        cdt = self.compute_dtype
        if self.kind == "1x1":
            out = sparse_conv_1x1(feats, self.weight, out_valid,
                                  compute_dtype=cdt)
        else:
            fn = _CONVS[self.kind][1]
            if kmap.shape[0] != self.weight.shape[0]:
                raise ValueError(f"a {self.kernel_size} conv over a map of "
                                 f"{kmap.shape[0]} offsets")
            args = (feats.to(cdt).contiguous(), self.weight, kmap)
            if self.kind != "subm":
                k2 = self.kind != "strided"
                if kmap_t is None or (k2 and plan is None):
                    raise ValueError(
                        f"a {self.kind} conv needs kmap_t, the transposed "
                        "map of its backward" + (", and the coarse level's "
                                                 "parity plan" if k2 else ""))
                args += (kmap_t, plan) if k2 else (kmap_t,)
            out = torch.where(out_valid[:, None], fn.apply(*args), 0.0)
            out = out.to(torch.promote_types(feats.dtype, cdt))
        if self.bias is not None:
            out = out + torch.where(out_valid[:, None], self.bias, 0.0)
        return out


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows (torch BN eps 1e-5); padding rows come out
    zero. Training (``openpcseg_tpu/models/layers.py:199-220``): float32
    statistics over the valid rows only (count at least 1), the biased
    variance to normalise, the unbiased one into the running estimate with
    EMA decay 0.9 (torch momentum 0.1). Eval: the running statistics.
    With ``group`` set (``parallel.ddp.sync_batchnorm``, JAX's
    ``axis_name``) the count and sums are summed over the ranks before the
    mean and variance, through a reduce whose backward sums the cotangents
    over the ranks too.

    The variance is JAX's E[x^2] - mean^2, or with ``centered`` the mean
    squared deviation from the mean (a second pass). Where an input
    channel sits far from zero against its spread, E[x^2] - mean^2 cancels
    most of float32's digits, and two devices summing in other orders
    keep different ones: Cylinder3D's raw point features on the ray-cast
    scans (a cell-centre height of mean 2.096, sd 0.0093) lose about three
    of seven, which moved the card's bf16 train step 3e-3 away from the
    CPU's at its first layer. Its BN on those features is centred; synced,
    it reduces twice: the count and sum, then the squared deviations from
    the global mean."""

    def __init__(self, c: int, eps: float = 1e-5, centered: bool = False):
        super().__init__()
        self.eps = eps
        self.centered = centered
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.group = None    # a process group: statistics over its ranks

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            m = valid.float()[:, None]
            cnt, s1 = m.sum(), (xf * m).sum(0)
            s2 = None if self.centered else (xf * xf * m).sum(0)
            if self.group is not None:     # JAX layers.py:205-208
                c = s1.shape[0]
                tot = all_reduce_sum(torch.cat(
                    [cnt[None], s1] + ([] if s2 is None else [s2])),
                    self.group)
                cnt, s1 = tot[0], tot[1:1 + c]
                s2 = None if s2 is None else tot[1 + c:]
            cnt = cnt.clamp(min=1.0)
            mean = s1 / cnt
            if self.centered:
                dev = (xf - mean) * m
                ss = (dev * dev).sum(0)
                if self.group is not None:
                    ss = all_reduce_sum(ss, self.group)
                var = ss / cnt
            else:
                var = (s2 / cnt - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                self.running_mean.mul_(_BN_DECAY).add_(
                    (1 - _BN_DECAY) * mean)
                self.running_var.mul_(_BN_DECAY).add_(
                    (1 - _BN_DECAY) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * inv + self.bias
        return torch.where(valid[:, None], y, 0.0).to(x.dtype)


class BasicConvBlock(nn.Module):
    """conv -> BN -> ReLU."""

    def __init__(self, cin: int, cout: int, kind: str = "subm",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = SparseConv(cin, cout, kind, compute_dtype)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, feats, kmap, out_valid, kmap_t=None, plan=None):
        return torch.relu(self.bn(self.conv(feats, kmap, out_valid, kmap_t,
                                            plan), out_valid))


class ResidualBlock(nn.Module):
    """conv-BN-ReLU-conv-BN + shortcut (1x1 conv + BN when the width
    changes), within one level; it returns `cout` channels."""

    expansion = 1

    def __init__(self, cin: int, cout: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = SparseConv(cin, cout, "subm", compute_dtype)
        self.bn1 = MaskedBatchNorm(cout)
        self.conv2 = SparseConv(cout, cout, "subm", compute_dtype)
        self.bn2 = MaskedBatchNorm(cout)
        self.shortcut = None
        if cin != cout:
            self.shortcut = SparseConv(cin, cout, "1x1", compute_dtype)
            self.bn_sc = MaskedBatchNorm(cout)

    def forward(self, feats, kmap, valid):
        x = torch.relu(self.bn1(self.conv1(feats, kmap, valid), valid))
        x = self.bn2(self.conv2(x, kmap, valid), valid)
        sc = feats
        if self.shortcut is not None:
            sc = self.bn_sc(self.shortcut(feats, None, valid), valid)
        return torch.relu(x + sc)


class Bottleneck(nn.Module):
    """1x1 -> BN/ReLU -> 3^3 submanifold -> BN/ReLU -> 1x1 to 4 x `planes`
    -> BN, plus the shortcut (identity where the input is already 4 x
    `planes` wide, else a 1x1 conv and BN), then ReLU, within one level
    (JAX ``layers.py Bottleneck``, :273-303). It returns 4 x `planes`
    channels: the stages that follow take that width."""

    expansion = 4

    def __init__(self, cin: int, planes: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = SparseConv(cin, planes, "1x1", compute_dtype)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, "subm", compute_dtype)
        self.bn2 = MaskedBatchNorm(planes)
        self.conv3 = SparseConv(planes, out, "1x1", compute_dtype)
        self.bn3 = MaskedBatchNorm(out)
        self.shortcut = None
        if cin != out:
            self.shortcut = SparseConv(cin, out, "1x1", compute_dtype)
            self.bn_sc = MaskedBatchNorm(out)

    def forward(self, feats, kmap, valid):
        x = torch.relu(self.bn1(self.conv1(feats, None, valid), valid))
        x = torch.relu(self.bn2(self.conv2(x, kmap, valid), valid))
        x = self.bn3(self.conv3(x, None, valid), valid)
        sc = feats
        if self.shortcut is not None:
            sc = self.bn_sc(self.shortcut(feats, None, valid), valid)
        return torch.relu(x + sc)


BLOCKS = {"ResBlock": ResidualBlock, "Bottleneck": Bottleneck}


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with keep probability 1 - p, drawn from an explicit
    generator (flax ``nn.Dropout``: kept entries scaled by 1 / (1 - p)).
    The draws cannot match JAX's bit for bit; p = 0 is the identity."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with p > 0 needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def repeated_blocks(block_cls, cin: int, planes: int, n: int,
                    compute_dtype: torch.dtype) -> nn.ModuleList:
    """n blocks: the first takes cin -> planes x its expansion, the rest
    carry that width (JAX scans blocks 2..n over stacked parameters; here
    a plain loop)."""
    width = planes * block_cls.expansion
    blocks: List[nn.Module] = [block_cls(cin, planes, compute_dtype)]
    blocks += [block_cls(width, planes, compute_dtype)
               for _ in range(n - 1)]
    return nn.ModuleList(blocks)
