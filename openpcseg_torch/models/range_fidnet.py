"""FIDNet: range-image segmentor with a pointwise stem, a ResNet34 trunk
and an interpolate-and-concat semantic head.

Counterpart of ``openpcseg_tpu/models/range_fidnet.py`` in NCHW: a 1x1
stem 6 -> 64 -> 128 -> 256 -> 512 (bias, BN, LeakyReLU), CENet's four
128-wide BasicBlock stages [3, 4, 6, 3] at strides [1, 2, 2, 2], the
strided scales resized back (bilinear, align_corners=True), a
1024-channel concat and the head 1024 -> 512 -> 128 -> num_class (1x1
convs). No aux heads. Input [B, H, W, 6]; output (logits [B, num_class,
H, W], []).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from .range_cenet import BasicConv2d, multiscale, resnet_stages
from .range_layers import Conv2d, reset_range_parameters, to_nchw


def _pointwise(cin: int, cout: int) -> BasicConv2d:
    """1x1 conv with its bias -> BN -> LeakyReLU."""
    return BasicConv2d(cin, cout, 1, bias=True)


class FIDNet(nn.Module):
    MODALITY = "range"

    def __init__(self, model_cfgs: Dict[str, Any], num_class: int,
                 **_unused):
        super().__init__()
        layers = model_cfgs.get("LAYERS", [3, 4, 6, 3])
        widths = (6, 64, 128, 256, 512)
        self.stem = nn.Sequential(*(_pointwise(a, b) for a, b in
                                    zip(widths[:-1], widths[1:])))
        self.stages = resnet_stages(512, layers)
        self.head = nn.Sequential(_pointwise(1024, 512),
                                  _pointwise(512, 128))
        self.semantic_output = Conv2d(128, num_class, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_range_parameters(self, generator)

    def forward(self, scan: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.stem(to_nchw(scan))
        x_1, resized = multiscale(x, self.stages)
        y = self.head(torch.cat([x, x_1, *resized], 1))
        return self.semantic_output(y), []
