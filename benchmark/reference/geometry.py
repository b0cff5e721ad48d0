"""Plain reference geometry of a MinkUNet step, in PyTorch.

From the padded scans the benchmark hands to both sides (xyz [B, Np, 3],
feats [B, Np, C], labels [B, Np], valid [B, Np]) it works out again what
the program's voxelize and geometry pass build, with none of their
tables: no capacities, no padding rows, no packed-key kernel maps. Each
level is the exact list of its voxels; each map is a list of (offset,
input rows, output rows) pairs. Semantics, as OpenPCSeg's MinkUNet
defines them:

- voxelize: grid = round(xyz / voxel_size), shifted by each scan's
  minimum over its valid points; a voxel takes the features and label of
  its first point (lowest index in the scan);
- level l + 1 is unique(floor(c / 2)) of level l, each voxel's parent the
  voxel that holds it;
- a 3x3x3 submanifold conv at voxel n reads the voxel at n + d for each
  offset d, the offsets row-major over (dx, dy, dz) in {-1, 0, 1}^3: the
  weight layout [27, Cin, Cout];
- a k2/s2 down conv sums each coarse voxel's children, child c with
  weight[px * 4 + py * 2 + pz], p = c & 1; the transposed up conv gives
  each fine voxel its parent's features times the same weight slot;
- devoxelizing level l to the level-0 voxels is trilinear: a point at
  p = c0 / 2^l reads the 8 level-l voxels at floor(p) + (cx, cy, cz),
  corner cx * 4 + cy * 2 + cz, with weight prod(frac or 1 - frac); a
  missing corner adds nothing, and the weights are not renormalised.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

BITS = 16                      # bits per coordinate in a key
LIMIT = 1 << BITS


def _keys(coords: torch.Tensor) -> torch.Tensor:
    """int64 keys of (b, x, y, z) rows [N, 4], each in [0, 2^16)."""
    c = coords.long()
    return (((c[:, 0] << BITS | c[:, 1]) << BITS | c[:, 2]) << BITS) | c[:, 3]


def _decode(keys: torch.Tensor) -> torch.Tensor:
    m = LIMIT - 1
    return torch.stack([keys >> 3 * BITS, keys >> 2 * BITS & m,
                        keys >> BITS & m, keys & m], dim=1)


def _lookup(table: torch.Tensor, q: torch.Tensor,
            ok: torch.Tensor) -> torch.Tensor:
    """Row of each query key in the sorted key table, -1 on a miss or
    where `ok` is False."""
    pos = torch.searchsorted(table, q).clamp(max=table.numel() - 1)
    return torch.where(ok & (table[pos] == q), pos, -1)


@dataclass
class Level:
    coords: torch.Tensor                 # [N, 4] int64 (b, x, y, z), sorted
    keys: torch.Tensor                   # [N] int64, sorted
    parent: torch.Tensor = None          # [N] row in the next level
    subm: List[Tuple[int, torch.Tensor, torch.Tensor]] = field(
        default_factory=list)            # (offset, input rows, output rows)
    updown: List[Tuple[int, torch.Tensor, torch.Tensor]] = field(
        default_factory=list)            # (offset, rows here, parent rows)

    @property
    def n(self) -> int:
        return self.keys.numel()


@dataclass
class Geometry:
    """One batch worked out again: the level-0 voxels' features and
    labels, each point's voxel, every level and map, and the devoxelize
    corners of each level named in ``devox``."""

    feats: torch.Tensor                  # [N0, C] float32, first point's
    labels: torch.Tensor                 # [N0] int64, first point's
    point_voxel: torch.Tensor            # [B * Np] level-0 row, -1 none
    levels: List[Level]
    devox: Dict[int, Tuple[torch.Tensor, torch.Tensor]]  # l -> (idx, w)

    def counts(self) -> List[int]:
        return [lv.n for lv in self.levels]


def voxelize(xyz, feats, labels, valid, voxel_size: float):
    """-> (level-0 Level, voxel features, voxel labels, point -> voxel)."""
    b, n_pts, _ = xyz.shape
    grid = torch.round(xyz / voxel_size).long()
    big = torch.iinfo(torch.int64).max
    mins = torch.where(valid[..., None], grid, big).amin(dim=1, keepdim=True)
    grid = grid - torch.where(mins == big, 0, mins)
    flat_valid = valid.reshape(-1)
    coords = torch.cat([torch.arange(b, device=xyz.device).repeat_interleave(
        n_pts)[:, None], grid.reshape(-1, 3)], dim=1)[flat_valid]
    if coords.numel() and (coords.min() < 0 or coords.max() >= LIMIT):
        raise ValueError("a scan spans more than 2^16 voxels on an axis")
    keys, inverse = torch.unique(_keys(coords), sorted=True,
                                 return_inverse=True)
    point_idx = torch.nonzero(flat_valid)[:, 0]
    first = torch.full((keys.numel(),), big, dtype=torch.int64,
                       device=xyz.device)
    first = first.scatter_reduce(0, inverse, point_idx, "amin")
    point_voxel = torch.full((b * n_pts,), -1, dtype=torch.int64,
                             device=xyz.device)
    point_voxel[point_idx] = inverse
    vfeats = feats.reshape(b * n_pts, -1)[first].float()
    vlabels = labels.reshape(-1)[first].long()
    return Level(_decode(keys), keys), vfeats, vlabels, point_voxel


def downsample(fine: Level) -> Level:
    c = fine.coords.clone()
    c[:, 1:] = torch.div(c[:, 1:], 2, rounding_mode="floor")
    keys, inverse = torch.unique(_keys(c), sorted=True, return_inverse=True)
    fine.parent = inverse
    return Level(_decode(keys), keys)


def offsets3(device) -> torch.Tensor:
    r = torch.arange(-1, 2, device=device)
    return torch.cartesian_prod(r, r, r)          # row-major (dx, dy, dz)


def subm_pairs(lv: Level):
    """(k, input rows, output rows) of the 3x3x3 submanifold conv."""
    pairs = []
    out_rows = torch.arange(lv.n, device=lv.keys.device)
    for k, d in enumerate(offsets3(lv.keys.device)):
        q = lv.coords.clone()
        q[:, 1:] += d
        ok = ((q[:, 1:] >= 0) & (q[:, 1:] < LIMIT)).all(dim=1)
        rows = _lookup(lv.keys, _keys(q.clamp(0, LIMIT - 1)), ok)
        hit = rows >= 0
        pairs.append((k, rows[hit], out_rows[hit]))
    return pairs


def parity(fine: Level) -> torch.Tensor:
    p = fine.coords[:, 1:] & 1
    return p[:, 0] * 4 + p[:, 1] * 2 + p[:, 2]


def updown_pairs(fine: Level):
    """(k, fine rows, coarse rows) of the k2/s2 maps between `fine` and
    the level above it: the down conv reads the fine rows into the coarse
    ones, the up conv the other way."""
    par = parity(fine)
    rows = torch.arange(fine.n, device=fine.keys.device)
    return [(k, rows[par == k], fine.parent[par == k]) for k in range(8)]


def devox_corners(l0: Level, lv: Level, stride: int):
    """[8, N0] corner rows (-1 missing) and trilinear weights of the
    level-0 voxels into level `lv` (stride 2^l)."""
    p = l0.coords[:, 1:].float() / stride
    base = torch.floor(p).long()
    frac = p - torch.floor(p)
    idx, w = [], []
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                off = torch.tensor([cx, cy, cz], device=p.device)
                q = torch.cat([l0.coords[:, :1], base + off], dim=1)
                ok = (q[:, 1:] < LIMIT).all(dim=1)
                rows = _lookup(lv.keys, _keys(q.clamp(max=LIMIT - 1)), ok)
                wt = torch.where(off > 0, frac, 1.0 - frac).prod(dim=1)
                idx.append(rows)
                w.append(torch.where(rows >= 0, wt, 0.0))
    return torch.stack(idx), torch.stack(w)


def level_counts(xyz, valid, *, voxel_size: float,
                 num_levels: int = 5) -> List[int]:
    """The voxels of each level of a batch, as ``build`` counts them,
    without its maps."""
    zeros = torch.zeros(xyz.shape[:2], dtype=torch.long, device=xyz.device)
    lv = voxelize(xyz, xyz, zeros, valid, voxel_size)[0]
    counts = [lv.n]
    for _ in range(1, num_levels):
        lv = downsample(lv)
        counts.append(lv.n)
    return counts


def build(xyz, feats, labels, valid, *, voxel_size: float,
          num_levels: int = 5, devox_levels=(4, 2)) -> Geometry:
    l0, vfeats, vlabels, point_voxel = voxelize(xyz, feats, labels, valid,
                                                voxel_size)
    levels = [l0]
    for _ in range(1, num_levels):
        levels.append(downsample(levels[-1]))
    for lv in levels:
        lv.subm = subm_pairs(lv)
        if lv.parent is not None:
            lv.updown = updown_pairs(lv)
    devox = {l: devox_corners(l0, levels[l], 2 ** l) for l in devox_levels
             if l > 0}
    return Geometry(vfeats, vlabels, point_voxel, levels, devox)
