"""SPVCNN: the sparse point-voxel CNN segmentor.

Counterpart of ``openpcseg_tpu/models/spvcnn.py``: MinkUNet's skeleton
(the same stem, down and up stages, and so the same parameters and kernel
shapes) plus a point branch. The points are the level-0 voxel sites, so
z0 = x0 (devox[0] is the identity). After the down stages and after the
second and fourth up stages the voxel features are devoxelized to the
points and a point MLP of the previous point features is added (z1, z2,
z3); z1 and z2 are mean-voxelized back into levels 4 and 2
(``ops.voxelize.voxelize_mean`` over ``pyr.p2v``), with dropout after each
mean-voxelize while training, and feed the decoder. The float32 classifier
reads the concatenation [z1, z2, z3] under MULTI_SCALE "concat" (JAX's
default), and z3 alone, cs[8] x expansion wide, under any other value
(JAX spvcnn.py:142-145).

Types follow JAX's: the point MLP's Linear holds float32 parameters, so it
computes in float32 on a bf16 input, as flax's promoting ``nn.Dense``
does; z1 and z2 are then float32, and so are the mean-voxelize and the
decoder convs' outputs that follow (each conv computes in the compute type
and returns the promoted one, ``layers.SparseConv``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core.tensor import VoxelPyramid
from ..ops.voxelize import voxelize_mean
from .layers import MaskedBatchNorm
from .minkunet import MinkUNet


def _lecun_normal(linear: nn.Linear, generator: torch.Generator) -> None:
    """flax's Dense default: a truncated-normal kernel of variance 1 /
    fan-in, zero bias."""
    w = linear.weight
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    nn.init.zeros_(linear.bias)


class PointTransform(nn.Module):
    """Linear -> masked BN over the valid points -> ReLU, in float32."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = nn.Linear(cin, cout)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.linear(x.float()), valid))


class SPVCNN(MinkUNet):
    DEVOX_LEVELS = (4, 2, 0)
    P2V_LEVELS = (4, 2)

    def __init__(self, model_cfgs: Dict[str, Any], num_class: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(model_cfgs, num_class, compute_dtype,
                         model_cfgs.get("MULTI_SCALE", "concat") == "concat")
        cr = model_cfgs.get("cr", 1.0)
        cs = [int(cr * x) for x in model_cfgs.get(
            "PLANES", [32, 32, 64, 128, 256, 256, 128, 96, 96])]
        e = self.expansion     # JAX spvcnn.py:92-93, :120
        self.point_transforms = nn.ModuleList([
            PointTransform(cs[0], cs[4] * e),
            PointTransform(cs[4] * e, cs[6] * e),
            PointTransform(cs[6] * e, cs[8] * e)])

    @classmethod
    def geometry_spec(cls) -> dict:
        return dict(num_levels=cls.NUM_LEVELS, devox_levels=cls.DEVOX_LEVELS,
                    p2v_levels=cls.P2V_LEVELS)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """MinkUNet's initializers, then flax's Dense default for each
        point MLP."""
        super().reset_parameters(generator)
        for pt in self.point_transforms:
            _lecun_normal(pt.linear, generator)

    def forward(self, voxel_feats: torch.Tensor, pyr: VoxelPyramid,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lv = pyr.levels
        valid = pyr.points.valid
        pt = self.point_transforms
        x = voxel_feats[:, :self.in_dim].to(self.compute_dtype)
        for blk in self.stem:
            x = blk(x, lv[0].subm_kmap, lv[0].valid)
        z0 = pyr.devox[0].apply(x)

        feats = [x]
        x = z0
        for i in range(4):
            x = self._down(i, x, lv)
            feats.append(x)

        z1 = pyr.devox[4].apply(x) + pt[0](z0, valid)
        y = self._dropout(voxelize_mean(z1, pyr.p2v[4]), generator)
        y = self._up(0, y, feats[3], lv)
        y = self._up(1, y, feats[2], lv)

        z2 = pyr.devox[2].apply(y) + pt[1](z1, valid)
        y = self._dropout(voxelize_mean(z2, pyr.p2v[2]), generator)
        y = self._up(2, y, feats[1], lv)
        y = self._up(3, y, feats[0], lv)

        z3 = pyr.devox[0].apply(y) + pt[2](z2, valid)
        feat = torch.cat([z1, z2, z3], dim=-1) if self.multi_scale else z3
        logits = self.classifier(feat.float())
        return torch.where(valid[:, None], logits, 0.0)
