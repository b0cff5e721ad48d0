"""RangeNet++ (DarkNet-53 backbone).

Counterpart of ``openpcseg_tpu/models/range_rangenet.py`` in NCHW: a
DarkNet residual encoder that halves the width only (3x3 convs at stride
(1, 2), flax "SAME": 0 before, 1 after along an even width), the input
before each downsample kept as that output stride's skip; a decoder of
(1, 4) transposed convs at stride (1, 2) (``range_layers.ConvTranspose2d``)
and expanding residual blocks, each adding its skip detached (JAX's
``stop_gradient``); dropout 0.01 after each encoder stage and twice
before the 3x3 head. BN momentum 0.01 (flax 0.99), LeakyReLU 0.1. The
input is the first 5 of the range image's 6 channels. Input [B, H, W, 6];
output (logits [B, num_class, H, W], []).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dropout
from .range_layers import (BatchNorm2d, Conv2d, ConvTranspose2d,
                           reset_range_parameters, to_nchw)

MODEL_BLOCKS = {21: [1, 1, 2, 2, 1], 53: [1, 2, 8, 8, 4]}
LEAKY = 0.1
BN_MOMENTUM = 0.99      # flax's decay; torch momentum 0.01
DROPOUT = 0.01
ENC_WIDTHS = (64, 128, 256, 512, 1024)
DEC_WIDTHS = (512, 256, 128, 64, 32)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, momentum=BN_MOMENTUM)


class DarkBasicBlock(nn.Module):
    """1x1 conv to planes[0], 3x3 conv to planes[1] (each without bias,
    BN, LeakyReLU 0.1), plus the input."""

    def __init__(self, cin: int, planes: Tuple[int, int]):
        super().__init__()
        self.conv1 = Conv2d(cin, planes[0], 1, bias=False)
        self.bn1 = _bn(planes[0])
        self.conv2 = Conv2d(planes[0], planes[1], 3, bias=False)
        self.bn2 = _bn(planes[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.bn1(self.conv1(x)), LEAKY)
        out = F.leaky_relu(self.bn2(self.conv2(out)), LEAKY)
        return out + x


class _ConvBN(nn.Module):
    """conv -> BN -> LeakyReLU 0.1."""

    def __init__(self, conv: nn.Module, c: int):
        super().__init__()
        self.conv = conv
        self.bn = _bn(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), LEAKY)


class RangeNet(nn.Module):
    MODALITY = "range"

    def __init__(self, model_cfgs: Dict[str, Any], num_class: int,
                 **_unused):
        super().__init__()
        blocks = MODEL_BLOCKS[model_cfgs.get("DARKNET_LAYERS", 53)]
        self.p = DROPOUT
        self.stem = _ConvBN(Conv2d(5, 32, 3, bias=False), 32)
        self.encoder = nn.ModuleList()
        cin = 32
        for width, n in zip(ENC_WIDTHS, blocks):
            self.encoder.append(nn.Sequential(
                _ConvBN(Conv2d(cin, width, 3, stride=(1, 2), bias=False),
                        width),
                *(DarkBasicBlock(width, (width // 2, width))
                  for _ in range(n))))
            cin = width
        self.decoder = nn.ModuleList()
        for width in DEC_WIDTHS:
            self.decoder.append(nn.Sequential(
                _ConvBN(ConvTranspose2d(cin, width), width),
                DarkBasicBlock(width, (2 * width, width))))
            cin = width
        self.head = Conv2d(32, num_class, 3)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_range_parameters(self, generator)

    def forward(self, scan: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        def drop(y):
            return dropout(y, self.p, generator) if self.training else y

        x = self.stem(to_nchw(scan[..., :5]))
        skips = []
        for stage in self.encoder:
            skips.append(x)
            x = drop(stage(x))
        for stage, skip in zip(self.decoder, reversed(skips)):
            x = stage(x) + skip.detach()
        return self.head(drop(drop(x))), []
