"""Cylinder3D (Cylinder_TS): the cylindrical-partition asymmetric sparse
UNet.

Counterpart of ``openpcseg_tpu/models/cylinder3d.py``: a point MLP over
the 9-wide point features -> scatter-max voxelize onto the cylindrical
grid (``ops.segment.segment_max`` over the point -> voxel inverse map) ->
Linear(16) + ReLU -> an asymmetric-kernel sparse UNet (ResContextBlock,
four CylResBlocks with k3 strided pools, four CylUpBlocks with k3
transposed convs, ReconBlock) -> a biased 3^3 sparse-conv head, plus the
point-refinement head (each point's level-0 voxel row, ``ops.devox.
PointGatherFn``, through Linear 256 + BN + LeakyReLU, added to the point
MLP's output, then Linear to the classes).

Every asymmetric submanifold kernel ((1, 3, 3), (3, 1, 3), (3, 1, 1), ...)
takes its rows of the level's one 3^3 map (``SparseLevel.subm_subset``);
the (2, 2, 1) height-preserving pools are the pyramid's per-axis down
factors (``geometry_spec``). The reference's quirks stay: LeakyReLU 0.01
before BN in every ConvActBN, and BN before the sigmoid in ReconBlock.

Types follow JAX's: the Linear layers hold float32 parameters and compute
in float32, as flax's promoting ``nn.Dense`` does, so the first conv's
input is float32 and every conv computes in the compute type and returns
float32 (``layers.SparseConv``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core.tensor import SparseLevel, VoxelPyramid
from ..ops.devox import PointGatherFn
from ..ops.segment import segment_max
from .layers import MaskedBatchNorm, SparseConv
from .spvcnn import _lecun_normal

LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU's default


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, LEAKY_SLOPE)


class AsymSubmConv(nn.Module):
    """Submanifold conv of an anisotropic kernel over its rows of the
    level's 3^3 map."""

    def __init__(self, cin: int, cout: int, kernel_size: tuple,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = SparseConv(cin, cout, "subm", compute_dtype, kernel_size)

    def forward(self, x: torch.Tensor, lvl: SparseLevel) -> torch.Tensor:
        return self.conv(x, lvl.subm_subset(self.kernel_size), lvl.valid)


class ConvActBN(nn.Module):
    """conv -> LeakyReLU -> BN (the reference's down-path order)."""

    def __init__(self, cin: int, cout: int, kernel_size: tuple,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.conv = AsymSubmConv(cin, cout, kernel_size, compute_dtype)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, x: torch.Tensor, lvl: SparseLevel) -> torch.Tensor:
        return self.bn(_leaky(self.conv(x, lvl)), lvl.valid)


class ResContextBlock(nn.Module):
    """(1,3,3) -> (3,1,3) beside (3,1,3) -> (1,3,3), summed."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvActBN(cin, cout, (1, 3, 3), compute_dtype),
            ConvActBN(cout, cout, (3, 1, 3), compute_dtype),
            ConvActBN(cin, cout, (3, 1, 3), compute_dtype),
            ConvActBN(cout, cout, (1, 3, 3), compute_dtype)])

    def forward(self, x, lvl):
        c = self.convs
        return c[3](c[2](x, lvl), lvl) + c[1](c[0](x, lvl), lvl)


class CylResBlock(nn.Module):
    """(3,1,3) -> (1,3,3) beside (1,3,3) -> (3,1,3), summed (the skip);
    then the k3 strided pool into the coarse level. Returns (pooled,
    skip)."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvActBN(cin, cout, (3, 1, 3), compute_dtype),
            ConvActBN(cout, cout, (1, 3, 3), compute_dtype),
            ConvActBN(cin, cout, (1, 3, 3), compute_dtype),
            ConvActBN(cout, cout, (3, 1, 3), compute_dtype)])
        self.pool = SparseConv(cout, cout, "strided", compute_dtype)

    def forward(self, x, lvl: SparseLevel, coarse: SparseLevel):
        c = self.convs
        res = c[3](c[2](x, lvl), lvl) + c[1](c[0](x, lvl), lvl)
        pooled = self.pool(res, coarse.down_kmap, coarse.valid,
                           kmap_t=lvl.up_kmap)
        return pooled, res


class CylUpBlock(nn.Module):
    """(3,3,3) at the coarse level, the k3 transposed conv into the fine
    level, plus the skip, then (1,3,3), (3,1,3) and (3,3,3)."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.pre = ConvActBN(cin, cout, (3, 3, 3), compute_dtype)
        self.up = SparseConv(cout, cout, "strided", compute_dtype)
        self.post = nn.ModuleList([
            ConvActBN(cout, cout, ks, compute_dtype)
            for ks in ((1, 3, 3), (3, 1, 3), (3, 3, 3))])

    def forward(self, x, skip, coarse: SparseLevel, fine: SparseLevel):
        up = self.pre(x, coarse)
        up = self.up(up, fine.up_kmap, fine.valid,
                     kmap_t=coarse.down_kmap) + skip
        for blk in self.post:
            up = blk(up, fine)
        return up


class ReconBlock(nn.Module):
    """Three 1-D gates, each conv -> BN -> sigmoid, summed, times the
    input."""

    KERNELS = ((3, 1, 1), (1, 3, 1), (1, 1, 3))

    def __init__(self, c: int, compute_dtype: torch.dtype):
        super().__init__()
        self.convs = nn.ModuleList([AsymSubmConv(c, c, ks, compute_dtype)
                                    for ks in self.KERNELS])
        self.bns = nn.ModuleList([MaskedBatchNorm(c) for _ in self.KERNELS])

    def forward(self, x, lvl):
        out = 0.0
        for conv, bn in zip(self.convs, self.bns):
            out = out + torch.sigmoid(bn(conv(x, lvl), lvl.valid))
        return out * x


class Cylinder_TS(nn.Module):
    """Config keys: IN_FEATURE_DIM (9), INIT_SIZE (32), POINT_REFINEMENT
    (True). forward(point_feats, pyr) -> (voxel logits [V, classes],
    {"point_refine_logits": [N, classes]} with the refinement head)."""

    NUM_LEVELS = 5
    INPUT_MODE = "point"

    def __init__(self, model_cfgs: Dict[str, Any], num_class: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = model_cfgs
        self.in_dim = cfg.get("IN_FEATURE_DIM", 9)
        init = cfg.get("INIT_SIZE", 32)
        self.point_refinement = bool(cfg.get("POINT_REFINEMENT", True))
        cdt = compute_dtype
        self.compute_dtype = cdt

        # the BN of the raw features is centred (MaskedBatchNorm): they sit
        # far from zero against their spread
        self.point_bns = nn.ModuleList(
            [MaskedBatchNorm(self.in_dim, centered=True)]
            + [MaskedBatchNorm(c) for c in (64, 128, 256)])
        self.point_linears = nn.ModuleList([
            nn.Linear(a, b) for a, b in ((self.in_dim, 64), (64, 128),
                                         (128, 256), (256, 256))])
        self.compress = nn.Linear(256, 16)
        self.context = ResContextBlock(16, init, cdt)
        widths = [init, 2 * init, 4 * init, 8 * init, 16 * init]
        self.downs = nn.ModuleList([CylResBlock(widths[i], widths[i + 1], cdt)
                                    for i in range(4)])
        # up block i: level 4 - i -> 3 - i, from the width below into the
        # skip's width
        self.ups = nn.ModuleList([
            CylUpBlock(widths[min(4, 5 - i)], widths[4 - i], cdt)
            for i in range(4)])
        self.recon = ReconBlock(2 * init, cdt)
        self.head = SparseConv(4 * init, num_class, "subm", cdt, bias=True)
        if self.point_refinement:
            self.refine = nn.Linear(4 * init, 256)
            self.refine_bn = MaskedBatchNorm(256)
            self.point_head = nn.Linear(256, num_class)

    @classmethod
    def geometry_spec(cls) -> dict:
        # levels 1-2 pool every axis, 3-4 keep the height (the reference's
        # height_pooling flags); every strided conv is k3
        return dict(num_levels=cls.NUM_LEVELS, subm_kernel=3,
                    updown_kernel=3,
                    down_factors=[1, 2, 2, (2, 2, 1), (2, 2, 1)],
                    devox_levels=(), p2v_levels=(0,))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults, drawn from `generator`: variance scaling for the
        convs (zero head bias), lecun-normal Linear kernels with zero bias,
        BN identity."""
        for m in self.modules():
            if isinstance(m, SparseConv):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Linear):
                _lecun_normal(m, generator)

    def point_mlp(self, point_feats: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
        """The point MLP over every point (float32): pp_out [N, 256]."""
        x = self.point_bns[0](point_feats[:, :self.in_dim].float(), valid)
        for lin, bn in zip(self.point_linears[:3], self.point_bns[1:]):
            x = torch.relu(bn(lin(x), valid))
        return self.point_linears[3](x)

    def voxelize(self, pp_out: torch.Tensor,
                 pyr: VoxelPyramid) -> torch.Tensor:
        """Scatter-max of the points into level 0, then Linear(16) + ReLU."""
        lv0 = pyr.levels[0]
        vox = segment_max(pp_out, pyr.point_to_voxel0, lv0.capacity)
        vox = torch.where(lv0.valid[:, None], vox, 0.0)
        return torch.relu(self.compress(vox))

    def refine_points(self, up0e: torch.Tensor, pp_out: torch.Tensor,
                      pyr: VoxelPyramid) -> torch.Tensor:
        """The point-refinement logits: each point's level-0 row of up0e,
        Linear 256 + BN + LeakyReLU, plus pp_out, then Linear to the
        classes; 0 on padding points."""
        valid = pyr.points.valid
        pf = PointGatherFn.apply(up0e.contiguous(), pyr.p2v[0])
        pf = _leaky(self.refine_bn(self.refine(pf), valid))
        return torch.where(valid[:, None], self.point_head(pp_out + pf), 0.0)

    def forward(self, point_feats: torch.Tensor, pyr: VoxelPyramid,
                generator: Optional[torch.Generator] = None):
        lv = pyr.levels
        pp_out = self.point_mlp(point_feats, pyr.points.valid)
        x = self.context(self.voxelize(pp_out, pyr), lv[0])
        skips = []
        for i, down in enumerate(self.downs):
            x, skip = down(x, lv[i], lv[i + 1])
            skips.append(skip)
        for i, up in enumerate(self.ups):
            x = up(x, skips[3 - i], lv[4 - i], lv[3 - i])
        up0e = torch.cat([self.recon(x, lv[0]), x], dim=-1)

        logits = self.head(up0e, lv[0].subm_kmap, lv[0].valid)
        aux = {}
        if self.point_refinement:
            aux["point_refine_logits"] = self.refine_points(up0e, pp_out,
                                                            pyr)
        return torch.where(lv[0].valid[:, None], logits, 0.0), aux
