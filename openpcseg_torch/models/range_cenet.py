"""CENet: range-image segmentor (a dense 2-D CNN).

Counterpart of ``openpcseg_tpu/models/range_cenet.py`` in NCHW: a 3-conv
stem (6 -> 64 -> 128 -> 128), four ResNet BasicBlock stages [3, 4, 6, 3]
at strides [1, 2, 2, 2], the three strided scales resized back to the
full image (bilinear, align_corners=True), a 640-channel concat -> 256
-> 128 -> 1x1 classifier, and with MODEL.IF_AUX three 1x1 aux heads on the
resized scales, whose logits training returns and eval does not. The
loss recipe is ``losses/range_losses.py range_seg_loss``.

The model takes the loader's range image [B, H, W, 6] and returns
(logits [B, num_class, H, W], aux logits: a list of the same shape).
``BasicConv2d``, ``BasicBlock`` and ``resize_bilinear`` are FIDNet's too.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .range_layers import (BatchNorm2d, Conv2d, reset_range_parameters,
                           to_nchw)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """align_corners=True bilinear resize of NCHW `x` to h x w (JAX
    ``_resize_bilinear``)."""
    if x.shape[2] == h and x.shape[3] == w:
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=True)


class BasicConv2d(nn.Module):
    """conv (no bias unless `bias`) -> BN -> LeakyReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, bias: bool = False):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, bias=bias)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """ResNet basic block with LeakyReLU; a 1x1 conv + BN shortcut where
    the stride or the width changes."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride, bias=False), BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.leaky_relu(out + identity)


def resnet_stages(cin: int, layers) -> nn.ModuleList:
    """The four 128-wide BasicBlock stages at strides 1, 2, 2, 2."""
    stages = []
    for n, stride in zip(layers, (1, 2, 2, 2)):
        blocks = [BasicBlock(cin, 128, stride)]
        blocks += [BasicBlock(128, 128) for _ in range(n - 1)]
        stages.append(nn.Sequential(*blocks))
        cin = 128
    return nn.ModuleList(stages)


def multiscale(x: torch.Tensor, stages: nn.ModuleList
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x_1 (stage 1) and the later stages' outputs resized to x's size."""
    h, w = x.shape[2], x.shape[3]
    x_1 = stages[0](x)
    y, resized = x_1, []
    for stage in stages[1:]:
        y = stage(y)
        resized.append(resize_bilinear(y, h, w))
    return x_1, resized


class CENet(nn.Module):
    MODALITY = "range"

    def __init__(self, model_cfgs: Dict[str, Any], num_class: int,
                 **_unused):
        super().__init__()
        layers = model_cfgs.get("LAYERS", [3, 4, 6, 3])
        self.stem = nn.Sequential(BasicConv2d(6, 64), BasicConv2d(64, 128),
                                  BasicConv2d(128, 128))
        self.stages = resnet_stages(128, layers)
        self.conv_1 = BasicConv2d(640, 256)
        self.conv_2 = BasicConv2d(256, 128)
        self.semantic_output = Conv2d(128, num_class, 1)
        self.aux_heads = nn.ModuleList()
        if bool(model_cfgs.get("IF_AUX", True)):
            self.aux_heads.extend(Conv2d(128, num_class, 1)
                                  for _ in range(3))

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_range_parameters(self, generator)

    def forward(self, scan: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.stem(to_nchw(scan))
        x_1, resized = multiscale(x, self.stages)
        out = self.conv_2(self.conv_1(torch.cat([x, x_1, *resized], 1)))
        logits = self.semantic_output(out)
        if not self.training:
            return logits, []
        return logits, [head(r) for head, r in zip(self.aux_heads, resized)]
