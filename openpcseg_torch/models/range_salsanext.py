"""SalsaNext: range-image segmentor (dilated ResContext blocks, pooled
residual blocks, pixel-shuffle up blocks).

Counterpart of ``openpcseg_tpu/models/range_salsanext.py`` in NCHW.
Dropout (p = 0.2, hard-coded as in JAX; the blocks' ``p``) draws from the
generator the caller passes, the task's. ``pixel_shuffle`` and
``SalsaNextBackbone`` are RPVNet's range branch too. Input [B, H, W, 6];
output (logits [B, num_class, H, W], []).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dropout
from .range_layers import (BatchNorm2d, Conv2d, reset_range_parameters,
                           to_nchw)

DROPOUT = 0.2


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[B, C r^2, H, W] -> [B, C, H r, W r]: out[c, h r + i, w r + j] =
    in[c r^2 + i r + j, h, w], the order of JAX's NHWC ``pixel_shuffle``."""
    return F.pixel_shuffle(x, r)


def _dilated2x2(c: int) -> Conv2d:
    """The 2x2 conv at dilation 2 with explicit padding ((1, 1), (1, 1))."""
    return Conv2d(c, c, 2, dilation=2, padding=((1, 1), (1, 1)))


class ResContextBlock(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv1 = Conv2d(cin, c, 1)
        self.conv2 = Conv2d(c, c, 3)
        self.bn1 = BatchNorm2d(c)
        self.conv3 = Conv2d(c, c, 3, dilation=2)
        self.bn2 = BatchNorm2d(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = F.leaky_relu(self.conv1(x))
        res1 = self.bn1(F.leaky_relu(self.conv2(shortcut)))
        res2 = self.bn2(F.leaky_relu(self.conv3(res1)))
        return shortcut + res2


class SalsaResBlock(nn.Module):
    """Returns (the block's output after dropout and, with ``pooling``,
    the 3x3 / 2 / 1 average pool that counts the padding; the skip)."""

    def __init__(self, cin: int, c: int, pooling: bool = True,
                 drop_out: bool = True):
        super().__init__()
        self.pooling = pooling
        self.drop_out = drop_out
        self.p = DROPOUT
        self.conv1 = Conv2d(cin, c, 1)
        self.conv2 = Conv2d(cin, c, 3)
        self.bn1 = BatchNorm2d(c)
        self.conv3 = Conv2d(c, c, 3, dilation=2)
        self.bn2 = BatchNorm2d(c)
        self.conv4 = _dilated2x2(c)
        self.bn3 = BatchNorm2d(c)
        self.conv5 = Conv2d(3 * c, c, 1)
        self.bn4 = BatchNorm2d(c)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        shortcut = F.leaky_relu(self.conv1(x))
        res1 = self.bn1(F.leaky_relu(self.conv2(x)))
        res2 = self.bn2(F.leaky_relu(self.conv3(res1)))
        res3 = self.bn3(F.leaky_relu(self.conv4(res2)))
        res = shortcut + self.bn4(F.leaky_relu(
            self.conv5(torch.cat([res1, res2, res3], 1))))
        out = res
        if self.drop_out and self.training:
            out = dropout(res, self.p, generator)
        if self.pooling:
            # an NCHW-contiguous copy: the channels-last backward of
            # avg_pool2d is wrong on the card (models/rpvnet.py)
            out = F.avg_pool2d(out.contiguous(), 3, 2, 1,
                               count_include_pad=True)
        return out, res


class SalsaUpBlock(nn.Module):
    def __init__(self, cin: int, skip_c: int, c: int, drop_out: bool = True):
        super().__init__()
        self.drop_out = drop_out
        self.p = DROPOUT
        self.conv1 = Conv2d(cin // 4 + skip_c, c, 3)
        self.bn1 = BatchNorm2d(c)
        self.conv2 = Conv2d(c, c, 3, dilation=2)
        self.bn2 = BatchNorm2d(c)
        self.conv3 = _dilated2x2(c)
        self.bn3 = BatchNorm2d(c)
        self.conv4 = Conv2d(3 * c, c, 1)
        self.bn4 = BatchNorm2d(c)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        drop = self.drop_out and self.training

        def maybe_drop(y):
            return dropout(y, self.p, generator) if drop else y

        up = torch.cat([maybe_drop(pixel_shuffle(x, 2)), skip], 1)
        up = maybe_drop(up)
        e1 = self.bn1(F.leaky_relu(self.conv1(up)))
        e2 = self.bn2(F.leaky_relu(self.conv2(e1)))
        e3 = self.bn3(F.leaky_relu(self.conv3(e2)))
        e = self.bn4(F.leaky_relu(self.conv4(torch.cat([e1, e2, e3], 1))))
        return maybe_drop(e)


class SalsaNextBackbone(nn.Module):
    """The encoder-decoder trunk (base width 32): 3 ResContext blocks, 4
    pooled residual blocks and one unpooled, 4 up blocks."""

    def __init__(self, cin: int = 6, base: int = 32, in_stem: bool = True):
        super().__init__()
        b = base
        self.stem = nn.ModuleList()
        if in_stem:
            self.stem.extend([ResContextBlock(cin, b), ResContextBlock(b, b),
                              ResContextBlock(b, b)])
            cin = b
        self.downs = nn.ModuleList([
            SalsaResBlock(cin, 2 * b, pooling=True, drop_out=False),
            SalsaResBlock(2 * b, 4 * b), SalsaResBlock(4 * b, 8 * b),
            SalsaResBlock(8 * b, 8 * b),
            SalsaResBlock(8 * b, 8 * b, pooling=False)])
        self.ups = nn.ModuleList([
            SalsaUpBlock(8 * b, 8 * b, 4 * b),
            SalsaUpBlock(4 * b, 8 * b, 4 * b),
            SalsaUpBlock(4 * b, 4 * b, 2 * b),
            SalsaUpBlock(2 * b, 2 * b, b, drop_out=False)])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for blk in self.stem:
            x = blk(x)
        skips = []
        for blk in self.downs:
            x, skip = blk(x, generator)
            skips.append(skip)
        for blk, skip in zip(self.ups, reversed(skips[:-1])):
            x = blk(x, skip, generator)
        return x


class SalsaNext(nn.Module):
    MODALITY = "range"

    def __init__(self, model_cfgs: Dict[str, Any], num_class: int,
                 **_unused):
        super().__init__()
        self.backbone = SalsaNextBackbone(base=32)
        self.logits = Conv2d(32, num_class, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_range_parameters(self, generator)

    def forward(self, scan: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        return self.logits(self.backbone(to_nchw(scan), generator)), []
