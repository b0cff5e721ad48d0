"""Dense 2-D layers of the range-view models, with flax's arithmetic.

The JAX package builds CENet, FIDNet, SalsaNext and RangeNet from flax's
``nn.Conv``, ``nn.ConvTranspose`` and ``nn.BatchNorm`` in NHWC; the port
runs NCHW ``torch.nn`` layers that compute the same functions:

- ``Conv2d``: flax's "SAME" padding, worked out from the input's size at
  each call. Along an axis of n pixels the output has ceil(n / stride)
  pixels and the padding that needs is split with the smaller half
  before: an even size under a stride-2 3x3 conv pads 0 before and 1
  after, where ``padding=1`` would shift every output by a pixel. An
  asymmetric split pads with ``F.pad`` first; an explicit ``padding``
  (SalsaNext's 2x2 dilated convs) is used as given.
- ``ConvTranspose2d``: flax ``nn.ConvTranspose`` (``transpose_kernel=
  False``, "SAME") at RangeNet's (1, 4) kernel and (1, 2) stride, which
  is torch's transposed conv with padding (0, 1) over the flax kernel
  flipped in both spatial axes, in and out kept (``utils/convert.py``
  flips it).
- ``BatchNorm2d``: flax ``nn.BatchNorm`` (eps 1e-5). Training normalises
  with the batch's mean and E[x^2] - mean^2 (clamped at 0), as flax does,
  and moves the running statistics by ``momentum`` (flax's: 0.9, or
  RangeNet's 0.99; torch's 0.1 and 0.01) toward the batch mean and the
  same biased variance (``nn.BatchNorm2d`` would take the unbiased one).
  Eval is ``F.batch_norm`` over the running statistics.
- ``reset_range_parameters``: flax's initialisers, lecun normal
  (truncated, fan in) kernels, zero biases, BN scale 1 and bias 0.

Everything here computes in float32, as the JAX modules do (none of the
four casts to ``compute_dtype``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# flax variance_scaling(1.0, "fan_in", "truncated_normal"): the std of a
# unit normal truncated to [-2, 2] is 0.87962566...
_TRUNC_STD = 0.87962566103423978


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(n: int, kernel: int, stride: int, dilation: int
              ) -> Tuple[int, int]:
    """(before, after) padding of XLA's "SAME" along an axis of n."""
    window = (kernel - 1) * dilation + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """nn.Conv2d with flax nn.Conv's padding: "SAME" from the input's
    size, or ``padding`` ((top, bottom), (left, right)) as given."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, dilation=1,
                 bias: bool = True,
                 padding: Optional[Sequence[Tuple[int, int]]] = None):
        super().__init__(cin, cout, _pair(kernel), _pair(stride), 0,
                         _pair(dilation), bias=bias)
        self.explicit = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.explicit is not None:
            (t, b), (l, r) = self.explicit
        else:
            t, b = same_pads(x.shape[2], self.kernel_size[0],
                             self.stride[0], self.dilation[0])
            l, r = same_pads(x.shape[3], self.kernel_size[1],
                             self.stride[1], self.dilation[1])
        if t == b and l == r:
            return F.conv2d(x, self.weight, self.bias, self.stride, (t, l),
                            self.dilation)
        return F.conv2d(F.pad(x, (l, r, t, b)), self.weight, self.bias,
                        self.stride, 0, self.dilation)


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax nn.ConvTranspose (SAME, no kernel flip) for a (1, 4) kernel at
    stride (1, 2): out width 2n, out height n. The weight [Cin, Cout, 1,
    4] holds flax's kernel [1, 4, Cin, Cout] flipped along both spatial
    axes."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, (1, 4), (1, 2), padding=(0, 1))


class BatchNorm2d(nn.Module):
    """flax nn.BatchNorm over NCHW (see the module docstring)."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean((0, 2, 3))
        var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return torch.addcmul(self.bias[:, None, None],
                             x - mean[:, None, None], mul[:, None, None])


def reset_range_parameters(model: nn.Module,
                           generator: torch.Generator) -> None:
    """flax's initialisers: every conv and transposed conv kernel a lecun
    normal (a unit normal truncated to [-2, 2], times sqrt(1 / fan in)
    over its std; fan in = Cin x kh x kw, for flax's transposed kernel
    too), zero biases, BN scale 1, bias 0, running mean 0, variance 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                cin = (m.in_channels if isinstance(m, nn.Conv2d)
                       else m.weight.shape[0])
                fan_in = cin * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def to_nchw(scan: torch.Tensor) -> torch.Tensor:
    """The loader's [B, H, W, C] range image as a contiguous NCHW tensor."""
    return scan.permute(0, 3, 1, 2).contiguous()
