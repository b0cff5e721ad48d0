"""Range <-> point feature transfer for RPVNet's fusion gates.

Counterpart of ``openpcseg_tpu/ops/range_fusion.py`` (XLA gathers and a
segment mean there, no Pallas kernel):

- ``range_to_point``: each point's bilinear sample of a range feature map
  [B, H, W, C] (torch ``grid_sample`` with align_corners=False: x = ((px
  + 1) W - 1) / 2, floored; the 2 x 2 corners clamped to the border, not
  zeroed), 0 for an invalid point;
- ``point_to_range``: the mean of the point features that fall in each of
  the B·H·W pixels, the pixel of a point the truncated (p + 1) / 2 ·
  (size - 1), clamped; an empty pixel gives 0.

Both are written here as JAX writes them (the plain versions the tests
hold to JAX, in JAX's NHWC layout), and again over tables that the
geometry pass builds once a step from each point's pxpy, scan and
validity (``range_tables``), which the model runs:

- ``bilinear_table``: a 4-corner ``DevoxTable`` [4, N] (flat pixel index,
  f32 weight) with its transpose by pixel; ``sample`` is K7 over it (a
  range map flattened to [B·H·W, C]) and its backward K8 over the
  transpose (counters ``r2p`` / ``r2p_bwd``);
- ``pixel_table``: a one-corner table [1, N] (the pixel of each point,
  weight 1; ``core.geometry.p2v_table``); ``scatter_mean`` is K8 over it
  (the sum), divided by each pixel's count, and its backward K7 over it
  with weight 1 / count (counters ``p2r`` / ``p2r_bwd``).

So on the card neither direction adds floats with atomics: each pixel's
and each point's sum runs in a fixed order and repeats bit for bit. The
index arithmetic is float32 in JAX's order of operations: ``pxpy`` of the
fusion view is 2 (ix / (W - 1) - 0.5), so (p + 1) / 2 (W - 1) lands on an
integer for every point, and the order decides between ix and ix - 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from ..core.geometry import devox_table, p2v_table
from ..core.tensor import DevoxTable
from .devox import DevoxFn, VoxelizeMeanFn
from .segment import segment_mean

R2P = ("r2p", "r2p_bwd")
P2R = ("p2r", "p2r_bwd")


def _bilinear(pxpy: torch.Tensor, h: int, w: int):
    """Corner (y0, x0) and the fractions (fy, fx), float32 as JAX."""
    x = ((pxpy[:, 0] + 1.0) * w - 1.0) / 2.0
    y = ((pxpy[:, 1] + 1.0) * h - 1.0) / 2.0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return y0.to(torch.int32), x0.to(torch.int32), y - y0, x - x0


def _corners(pxpy, batch_idx, h, w):
    """The 4 corners' flat pixel rows [4, N] (int64) and weights [4, N],
    in JAX's order: (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 +
    1)."""
    y0, x0, fy, fx = _bilinear(pxpy, h, w)
    bi = batch_idx.clamp(min=0).long()
    rows, wts = [], []
    for dy, dx, wt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                       (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        yc = (y0 + dy).clamp(0, h - 1).long()
        xc = (x0 + dx).clamp(0, w - 1).long()
        rows.append((bi * h + yc) * w + xc)
        wts.append(wt)
    return torch.stack(rows), torch.stack(wts)


def range_to_point(fmap: torch.Tensor, pxpy: torch.Tensor,
                   batch_idx: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """JAX ``range_to_point``: fmap [B, H, W, C], pxpy [N, 2] in [-1, 1],
    batch_idx [N], valid [N] -> [N, C], 0 on invalid points."""
    b, h, w, c = fmap.shape
    rows, wts = _corners(pxpy, batch_idx, h, w)
    flat = fmap.reshape(b * h * w, c)
    out = flat[rows[0]] * wts[0][:, None]
    for k in range(1, 4):
        out = out + flat[rows[k]] * wts[k][:, None]
    return torch.where(valid[:, None], out, 0.0)


def pixel_index(pxpy: torch.Tensor, batch_idx: torch.Tensor,
                valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Each point's flat pixel (b H + y) W + x [N] int32, -1 where invalid:
    x = int((px + 1) / 2 (W - 1)) truncated, clamped (JAX's order)."""
    x = ((pxpy[:, 0] + 1.0) / 2.0 * (w - 1)).to(torch.int32)
    y = ((pxpy[:, 1] + 1.0) / 2.0 * (h - 1)).to(torch.int32)
    x = x.clamp(0, w - 1)
    y = y.clamp(0, h - 1)
    lin = (batch_idx.clamp(min=0) * h + y) * w + x
    return torch.where(valid, lin, -1).to(torch.int32)


def point_to_range(pf: torch.Tensor, pxpy: torch.Tensor,
                   batch_idx: torch.Tensor, valid: torch.Tensor,
                   b: int, h: int, w: int) -> torch.Tensor:
    """JAX ``point_to_range``: the mean of pf [N, C] per pixel -> [B, H,
    W, C], 0 where no valid point falls."""
    lin = pixel_index(pxpy, batch_idx, valid, h, w)
    mean, _ = segment_mean(pf, lin, b * h * w)
    return mean.reshape(b, h, w, pf.shape[-1])


def bilinear_table(pxpy, batch_idx, valid, b: int, h: int,
                   w: int) -> DevoxTable:
    """The 4-corner table of ``range_to_point`` over a [B, H, W] map: idx
    [4, N] the corners' flat pixels (-1 on invalid points), weights [4,
    N] float32 (0 there), with its transpose by pixel for K8."""
    rows, wts = _corners(pxpy, batch_idx, h, w)
    idx = torch.where(valid[None], rows, -1).to(torch.int32).contiguous()
    wts = torch.where(valid[None], wts, 0.0).to(torch.float32).contiguous()
    return devox_table(idx, wts, b * h * w)


def pixel_table(pxpy, batch_idx, valid, b: int, h: int,
                w: int) -> DevoxTable:
    """The one-corner table of ``point_to_range``: idx [1, N] each point's
    pixel (``pixel_index``), weight 1; its transpose's row lengths are the
    pixels' counts."""
    return p2v_table(pixel_index(pxpy, batch_idx, valid, h, w), b * h * w)


@dataclass
class RangeTables:
    """The two tables of one range resolution [B, H, W]."""

    shape: Tuple[int, int, int]
    bilinear: DevoxTable
    pixel: DevoxTable


def range_tables(pxpy: torch.Tensor, batch_idx: torch.Tensor,
                 valid: torch.Tensor, b: int, h: int, w: int,
                 scales: Sequence[int]) -> Dict[Tuple[int, int], RangeTables]:
    """{(H / s, W / s): RangeTables} for each scale s of `scales`: fixed
    shapes, sorts and binary searches on the device, no host sync."""
    out = {}
    for s in scales:
        hs, ws = h // s, w // s
        out[hs, ws] = RangeTables(
            (b, hs, ws), bilinear_table(pxpy, batch_idx, valid, b, hs, ws),
            pixel_table(pxpy, batch_idx, valid, b, hs, ws))
    return out


def sample(fmap: torch.Tensor, tables: RangeTables) -> torch.Tensor:
    """``range_to_point`` of an NCHW map [B, C, H, W] over its bilinear
    table -> [N, C]: K7 (4 corners) forward, K8 over the transpose back."""
    b, c, h, w = fmap.shape
    if (b, h, w) != tables.shape:
        raise ValueError(f"range map {tuple(fmap.shape)} does not fit the "
                         f"tables of {tables.shape}")
    flat = fmap.permute(0, 2, 3, 1).reshape(b * h * w, c).contiguous()
    return DevoxFn.apply(flat, tables.bilinear, R2P)


def scatter_mean(pf: torch.Tensor, tables: RangeTables) -> torch.Tensor:
    """``point_to_range`` of point features [N, C] over the pixel table ->
    an NCHW map [B, C, H, W]: K8 (the sum) forward, K7 back."""
    b, h, w = tables.shape
    mean = VoxelizeMeanFn.apply(pf.contiguous(), tables.pixel, P2R)
    return mean.reshape(b, h, w, pf.shape[1]).permute(0, 3, 1, 2)
