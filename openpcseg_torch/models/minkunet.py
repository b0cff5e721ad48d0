"""MinkUNet: sparse 3D UNet segmentor.

Counterpart of ``openpcseg_tpu/models/minkunet.py``: stem + 4 down stages
(stride-2 conv + residual blocks) + 4 up stages (transposed conv + skip
concat + blocks) + a float32 classifier over the devoxelized [z1, z2, z3]
of levels 4, 2 and 0. Config keys: IN_FEATURE_DIM, NUM_LAYER, PLANES, cr,
BLOCK, DROPOUT_P (JAX default 0.3; dropout after x4 and y2 while training,
drawn from the generator the caller passes).

BLOCK is JAX's: ResBlock or Bottleneck (JAX's default; 4x expansion).
With Bottleneck each stage's blocks return 4 x its planes, and the widths
follow JAX's, which flax infers from its inputs (JAX minkunet.py:55-79):
a down conv keeps the width it gets, an up conv reads the expanded width
of the stage below, the skips concatenate at their expanded widths, and
the classifier reads (cs[4] + cs[6] + cs[8]) x 4.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core.tensor import VoxelPyramid
from .layers import (BLOCKS, BasicConvBlock, MaskedBatchNorm, SparseConv,
                     dropout, repeated_blocks)


class MinkUNet(nn.Module):
    NUM_LEVELS = 5
    DEVOX_LEVELS = (4, 2, 0)

    def __init__(self, model_cfgs: Dict[str, Any], num_class: int,
                 compute_dtype: torch.dtype = torch.float32,
                 multi_scale: bool = True):
        """`multi_scale` False: the classifier reads the last level's
        features alone, cs[8] x expansion wide (SPVCNN's and RPVNet's
        MULTI_SCALE other than "concat")."""
        super().__init__()
        cfg = model_cfgs
        self.in_dim = cfg.get("IN_FEATURE_DIM", 4)
        num_layer = cfg.get("NUM_LAYER", [2, 3, 4, 6, 2, 2, 2, 2])
        block = cfg.get("BLOCK", "Bottleneck")
        if block not in BLOCKS:
            raise ValueError(f"BLOCK {block!r}: the blocks are "
                             f"{sorted(BLOCKS)}")
        block_cls = BLOCKS[block]
        self.expansion = exp = block_cls.expansion
        cr = cfg.get("cr", 1.0)
        cs = [int(cr * x) for x in
              cfg.get("PLANES", [32, 32, 64, 128, 256, 256, 128, 96, 96])]
        cdt = compute_dtype
        self.compute_dtype = cdt
        self.dropout_p = float(cfg.get("DROPOUT_P", 0.3))

        self.stem = nn.ModuleList([
            BasicConvBlock(self.in_dim, cs[0], "subm", cdt),
            BasicConvBlock(cs[0], cs[0], "subm", cdt)])
        self.downs = nn.ModuleList()
        self.down_blocks = nn.ModuleList()
        c = cs[0]
        skips = []
        for i in range(4):
            skips.append(c)
            self.downs.append(BasicConvBlock(c, c, "down", cdt))
            self.down_blocks.append(
                repeated_blocks(block_cls, c, cs[i + 1], num_layer[i], cdt))
            c = cs[i + 1] * exp
        self.ups = nn.ModuleList()
        self.up_bns = nn.ModuleList()
        self.up_blocks = nn.ModuleList()
        for i in range(4):
            planes = cs[5 + i]
            self.ups.append(SparseConv(c, planes, "up", cdt))
            self.up_bns.append(MaskedBatchNorm(planes))
            self.up_blocks.append(repeated_blocks(
                block_cls, planes + skips[3 - i], planes, num_layer[4 + i],
                cdt))
            c = planes * exp
        self.multi_scale = multi_scale
        width = cs[4] + cs[6] + cs[8] if multi_scale else cs[8]
        self.classifier = nn.Linear(width * exp, num_class)

    @classmethod
    def geometry_spec(cls) -> dict:
        return dict(num_levels=cls.NUM_LEVELS, devox_levels=cls.DEVOX_LEVELS)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's default initializers, drawn from `generator`: variance
        scaling for the convs, lecun-normal classifier, BN identity."""
        for m in self.modules():
            if isinstance(m, SparseConv):
                m.reset_parameters(generator)
        w = self.classifier.weight
        std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        nn.init.zeros_(self.classifier.bias)

    @staticmethod
    def _run(blocks, x, lvl):
        for b in blocks:
            x = b(x, lvl.subm_kmap, lvl.valid)
        return x

    def _down(self, i, x, lv):
        """Down stage i: level i -> i + 1 (k2/s2 conv block, then blocks)."""
        fine, coarse = lv[i], lv[i + 1]
        x = self.downs[i](x, coarse.down_kmap, coarse.valid,
                          kmap_t=fine.up_kmap, plan=coarse.parity_plan)
        return self._run(self.down_blocks[i], x, coarse)

    def _up(self, i, x, skip, lv):
        """Up stage i: level 4 - i -> 3 - i (transposed conv, BN, ReLU,
        concat with the skip, then blocks)."""
        coarse, fine = lv[4 - i], lv[3 - i]
        x = self.ups[i](x, fine.up_kmap, fine.valid,
                        kmap_t=coarse.down_kmap, plan=coarse.parity_plan)
        x = torch.relu(self.up_bns[i](x, fine.valid))
        return self._run(self.up_blocks[i], torch.cat([x, skip], dim=-1), fine)

    def _dropout(self, x, generator):
        return dropout(x, self.dropout_p, generator) if self.training else x

    def forward(self, voxel_feats: torch.Tensor, pyr: VoxelPyramid,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lv = pyr.levels
        x = voxel_feats[:, :self.in_dim].to(self.compute_dtype)
        for blk in self.stem:
            x = blk(x, lv[0].subm_kmap, lv[0].valid)

        feats = [x]
        for i in range(4):
            x = self._down(i, x, lv)
            feats.append(x)
        z = [pyr.devox[4].apply(x)]
        x = self._dropout(x, generator)

        for i in range(4):
            x = self._up(i, x, feats[3 - i], lv)
            if i == 1:
                z.append(pyr.devox[2].apply(x))
                x = self._dropout(x, generator)
        z.append(pyr.devox[0].apply(x))

        logits = self.classifier(torch.cat(z, dim=-1).float())
        return torch.where(pyr.points.valid[:, None], logits, 0.0)
