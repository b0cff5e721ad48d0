"""RPVNet: the range-point-voxel tri-branch fusion segmentor.

Counterpart of ``openpcseg_tpu/models/rpvnet.py``: MinkUNet's voxel
branch (the same stem, down and up stages), a simplified SalsaNext range
branch over the scan's 64 x 2048 image, and a point branch, fused at four
gates

    z_i = devoxelize(voxel) + range_to_point(range map) + point_mlp_i(z_{i-1})

whose sums feed the next stage of every branch: the voxel branch by
mean-voxelize (levels 4 and 2, ``ops.voxelize.voxelize_mean``), the range
branch by the mean of the points in each pixel (``ops.range_fusion
scatter_mean``). The points are the level-0 voxel sites, each with the
pxpy of its representative point (``SegTask``); the classifier reads the
concatenation [z1, z2, z3] in float32 (JAX's default MULTI_SCALE
"concat"; no shipped config sets another).

The range branch is NCHW inside (the loader's NHWC image is transposed at
the edge) and float32, as JAX's (its ``nn.Conv`` has no dtype and the
image is float32); the voxel branch computes in the task's compute type;
the point MLPs, the devoxelize weights and the classifier are float32.
The range maps go to the points over each resolution's bilinear table
(K7 with 4 corners, K8 back) and the points to the pixels over its pixel
table (K8, K7 back), tables ``SegTask.preprocess`` builds once a step
from each voxel's pxpy (``VoxelPyramid.range``).

BLOCK is ResBlock by default, as in JAX (rpvnet.py:151-152). A
Bottleneck voxel branch (4x expansion) cannot be built: JAX widens the
devoxelized voxel features and the point MLPs to 4 x the planes but not
the range branch, so its gate 1 adds a cs[4]-wide range feature to a 4 x
cs[4]-wide voxel one and fails at that add (a broadcast error at init);
the port refuses the config when it builds the model.

Dropout: ``RPVResBlock`` and ``RPVUpBlock`` drop at 0.2 while training
whatever DROPOUT_P says, as JAX hard-codes it; the mean-voxelized y1 and
y3 at DROPOUT_P. Every draw comes from the generator the caller passes
(the task's).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.tensor import VoxelPyramid
from ..ops.range_fusion import sample, scatter_mean
from ..ops.voxelize import voxelize_mean
from .layers import dropout
from .minkunet import MinkUNet
from .range_layers import (BatchNorm2d, Conv2d, reset_range_parameters,
                           to_nchw)
from .range_salsanext import ResContextBlock, pixel_shuffle
from .spvcnn import PointTransform, _lecun_normal

RANGE_DROPOUT = 0.2
RANGE_CHANNELS = 5      # the fusion view's image: 1/depth, intensity, xyz


class _RangeBlock(nn.Module):
    p = RANGE_DROPOUT

    def _drop(self, x, generator):
        if self.drop_out and self.training:
            return dropout(x, self.p, generator)
        return x


class RPVResBlock(_RangeBlock):
    """1x1 shortcut + (3x3 conv, LeakyReLU, BN); with ``pooling`` the
    3 x 3 / 2 sum pool over one pixel of zero padding divided by 9 (JAX's
    reduce_window; avg_pool2d counting the padding). Returns (pooled or
    the block's output, the skip)."""

    def __init__(self, cin: int, c: int, pooling: bool = True,
                 drop_out: bool = True):
        super().__init__()
        self.pooling = pooling
        self.drop_out = drop_out
        self.conv1 = Conv2d(cin, c, 1)
        self.conv2 = Conv2d(cin, c, 3)
        self.bn = BatchNorm2d(c)

    def forward(self, x, generator):
        r = F.leaky_relu(self.conv1(x)) + self.bn(F.leaky_relu(
            self.conv2(x)))
        if not self.pooling:
            return self._drop(r, generator), r
        # pool an NCHW-contiguous copy: the convs can hand back
        # channels-last maps, whose avg_pool2d backward is wrong on the
        # card (torch 2.11, CUDA 12.8: up to 0.9 off a unit-scale gradient;
        # tests/test_torch_cuda.py test_range_pools_backward)
        p = F.avg_pool2d(self._drop(r, generator).contiguous(), 3, 2, 1,
                         count_include_pad=True)
        return p, r


class RPVUpBlock(_RangeBlock):
    """pixel_shuffle(2), concat the skip, 3x3 conv, LeakyReLU, BN."""

    def __init__(self, cin: int, skip: int, c: int, drop_out: bool = True):
        super().__init__()
        self.drop_out = drop_out
        self.conv = Conv2d(cin // 4 + skip, c, 3)
        self.bn = BatchNorm2d(c)

    def forward(self, x, skip, generator):
        up = self._drop(pixel_shuffle(x, 2), generator)
        up = self._drop(torch.cat([up, skip], 1), generator)
        return self._drop(self.bn(F.leaky_relu(self.conv(up))), generator)


class RPVNet(MinkUNet):
    DEVOX_LEVELS = (4, 2, 0)
    P2V_LEVELS = (4, 2)
    INPUT_MODE = "fusion"
    # the range resolutions of the gates, as divisors of the image's: the
    # stem and the last up block (1), the pooled bottom (16), gate 2 (4)
    RANGE_SCALES = (1, 16, 4)

    def __init__(self, model_cfgs: Dict[str, Any], num_class: int,
                 compute_dtype: torch.dtype = torch.float32):
        cfg = dict(model_cfgs)
        cfg.setdefault("IN_FEATURE_DIM", 5)
        cfg.setdefault("BLOCK", "ResBlock")
        super().__init__(cfg, num_class, compute_dtype)
        if self.expansion != 1:
            raise ValueError(
                f"RPVNet with BLOCK {cfg['BLOCK']!r}: the gates add the "
                f"range branch's cs[4] channels to {self.expansion} x cs[4] "
                "voxel channels, which the JAX model cannot add either "
                "(rpvnet.py gate 1); RPVNet takes ResBlock")
        cr = cfg.get("cr", 1.0)
        cs = [int(cr * x) for x in cfg.get(
            "PLANES", [32, 32, 64, 128, 256, 256, 128, 96, 96])]
        self.point_transforms = nn.ModuleList([
            PointTransform(self.in_dim, cs[0]), PointTransform(cs[0], cs[4]),
            PointTransform(cs[4], cs[6]), PointTransform(cs[6], cs[8])])
        self.range_stem = nn.ModuleList([
            ResContextBlock(RANGE_CHANNELS, cs[0]),
            ResContextBlock(cs[0], cs[0]), ResContextBlock(cs[0], cs[0])])
        self.range_downs = nn.ModuleList([
            RPVResBlock(cs[0], cs[1], drop_out=False),
            RPVResBlock(cs[1], cs[2]), RPVResBlock(cs[2], cs[3]),
            RPVResBlock(cs[3], cs[4]),
            RPVResBlock(cs[4], cs[4], pooling=False)])
        self.range_ups = nn.ModuleList([
            RPVUpBlock(cs[4], cs[4], cs[5]), RPVUpBlock(cs[5], cs[3], cs[6]),
            RPVUpBlock(cs[6], cs[2], cs[7]),
            RPVUpBlock(cs[7], cs[1], cs[8], drop_out=False)])

    @classmethod
    def geometry_spec(cls) -> dict:
        return dict(num_levels=cls.NUM_LEVELS, devox_levels=cls.DEVOX_LEVELS,
                    p2v_levels=cls.P2V_LEVELS)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """MinkUNet's initializers, flax's Dense default for the point MLPs
        and flax's Conv / BatchNorm defaults for the range branch."""
        super().reset_parameters(generator)
        for pt in self.point_transforms:
            _lecun_normal(pt.linear, generator)
        for branch in (self.range_stem, self.range_downs, self.range_ups):
            reset_range_parameters(branch, generator)

    def forward(self, inputs: Dict[str, torch.Tensor], pyr: VoxelPyramid,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """inputs: ``voxel_feats`` [V, C] and ``range_image`` [B, H, W, 5];
        `pyr` carries the range tables -> logits [V, num_class], 0 on
        padding rows."""
        lv = pyr.levels
        valid = pyr.points.valid
        pt = self.point_transforms
        rimg = inputs["range_image"]
        b, h, w, _ = rimg.shape
        tables = pyr.range

        def r2p(fmap):
            return sample(fmap, tables[fmap.shape[2], fmap.shape[3]])

        def p2r(pf, scale):
            return scatter_mean(pf, tables[h // scale, w // scale])

        raw = inputs["voxel_feats"][:, :self.in_dim].to(self.compute_dtype)
        x = raw
        for blk in self.stem:
            x = blk(x, lv[0].subm_kmap, lv[0].valid)
        r = to_nchw(rimg.float())
        for blk in self.range_stem:
            r = blk(r)
        # gate 0; the points are the level-0 sites, so devox[0] is x itself
        z0 = pyr.devox[0].apply(x) + r2p(r) + pt[0](raw, valid)

        feats = [x]
        x = z0
        for i in range(4):
            x = self._down(i, x, lv)
            feats.append(x)
        r, skips = p2r(z0, 1), []
        for blk in self.range_downs:
            r, s = blk(r, generator)
            skips.append(s)

        # gate 1
        z1 = pyr.devox[4].apply(x) + r2p(r) + pt[1](z0, valid)
        y = self._dropout(voxelize_mean(z1, pyr.p2v[4]), generator)
        y = self._up(0, y, feats[3], lv)
        y = self._up(1, y, feats[2], lv)
        r = self.range_ups[0](p2r(z1, 16), skips[3], generator)
        r = self.range_ups[1](r, skips[2], generator)

        # gate 2
        z2 = pyr.devox[2].apply(y) + r2p(r) + pt[2](z1, valid)
        y = self._dropout(voxelize_mean(z2, pyr.p2v[2]), generator)
        y = self._up(2, y, feats[1], lv)
        y = self._up(3, y, feats[0], lv)
        r = self.range_ups[2](p2r(z2, 4), skips[1], generator)
        r = self.range_ups[3](r, skips[0], generator)

        # gate 3
        z3 = pyr.devox[0].apply(y) + r2p(r) + pt[3](z2, valid)
        logits = self.classifier(torch.cat([z1, z2, z3], -1).float())
        return torch.where(valid[:, None], logits, 0.0)
