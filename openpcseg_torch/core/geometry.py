"""Geometry pass: build the voxel pyramid and every kernel map of a step.

Counterpart of ``openpcseg_tpu/core/geometry.py build_pyramid``, voxel
modality (the points are the level-0 voxel sites) with isotropic stride-2
levels, as MinkUNet uses it. Features never enter here: the network that
follows is gathers and matmuls over these precomputed index tables.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..ops.coords import Keys, lookup_keys_z3, make_keys
from ..ops.kmap import _self_z_neighbors, build_downsample, build_subm_kmap
from ..ops.voxelize import (corner_offsets, devox_segments,
                            devox_transpose_table)
from .tensor import (DevoxTable, ParityPlan, PointBuffer, SparseLevel,
                     VoxelPyramid)

PARITY_TILE_ROWS = 64   # rows per tile of csrc/parent_gemm.cu (its BM)
# contributors one warp of K8 (csrc/devox.cu) sums at most: the longest
# serial chain of the transpose (chip_smoke.py times K8 at several)
DEVOX_CHUNK = 64


def _corner_table(lvl: SparseLevel) -> torch.Tensor:
    """[8, cap] rows of the {0,1}^3 corner neighbours of every level voxel,
    ordered cx*4 + cy*2 + cz (ops.voxelize.corner_offsets)."""
    cap = lvl.coords.shape[0]
    dev = lvl.coords.device
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    rows = [None] * 8
    rows[0] = torch.where(lvl.valid, iota, torch.full_like(iota, -1))
    rows[1] = _self_z_neighbors(lvl.keys, lvl.valid)[1]
    cols = ((0, 1), (1, 0), (1, 1))
    offs = torch.tensor([[cx, cy, 0] for cx, cy in cols], dtype=torch.int32,
                        device=dev)
    q = torch.cat([lvl.coords[None, :, :1].expand(3, cap, 1),
                   lvl.coords[None, :, 1:] + offs[:, None, :]], dim=-1)
    z3 = lookup_keys_z3(lvl.keys, make_keys(q, lvl.valid[None].expand(3, cap)))
    for ci, (cx, cy) in enumerate(cols):
        rows[cx * 4 + cy * 2 + 0] = z3[1, ci]
        rows[cx * 4 + cy * 2 + 1] = z3[2, ci]
    return torch.stack(rows)


def _devox_weights(point_coords: torch.Tensor, point_valid: torch.Tensor,
                   stride, idx: torch.Tensor) -> torch.Tensor:
    """[8, n] trilinear corner weights; zero on a missing corner."""
    p = point_coords / torch.tensor(stride, dtype=point_coords.dtype,
                                    device=point_coords.device)
    frac = p - torch.floor(p)
    offs = torch.as_tensor(corner_offsets(), device=p.device)
    w = torch.where(offs[:, None, :] > 0, frac[None], 1.0 - frac[None]).prod(-1)
    return torch.where((idx >= 0) & point_valid[None], w, torch.zeros_like(w))


def _updown_from_inverse(fine: SparseLevel, coarse: SparseLevel,
                         inverse: torch.Tensor, which: str) -> torch.Tensor:
    """k2/s2 kernel maps from the downsample inverse map: fine row i pairs
    with its parent inverse[i] at the offset given by its coordinate parity
    (index px*4 + py*2 + pz, the kernel_offsets(2) order)."""
    parity = fine.coords[:, 1:] & 1
    off_idx = parity[:, 0] * 4 + parity[:, 1] * 2 + parity[:, 2]
    n_f = fine.coords.shape[0]
    dev = fine.coords.device
    ok = fine.valid & (inverse >= 0)
    if which == "up":
        offs = torch.arange(8, dtype=off_idx.dtype, device=dev)[:, None]
        hit = ok[None, :] & (off_idx[None, :] == offs)
        return torch.where(hit, inverse[None, :].expand(8, n_f),
                           torch.full((8, n_f), -1, dtype=torch.int32,
                                      device=dev)).to(torch.int32)
    n_c = coarse.coords.shape[0]
    flat = torch.where(ok, off_idx * n_c + inverse,
                       torch.full_like(inverse, 8 * n_c)).long()
    out = torch.full((8 * n_c + 1,), -1, dtype=torch.int32, device=dev)
    out[flat] = torch.arange(n_f, dtype=torch.int32, device=dev)
    return out[:8 * n_c].reshape(8, n_c)


def build_parity_plan(down_kmap: torch.Tensor, n_fine: int,
                      tile_rows: int = PARITY_TILE_ROWS) -> ParityPlan:
    """Group a coarse level's down map [8, N_coarse] (fine row per (parity,
    coarse row), -1 miss) by parity. Read row-major, its hits are the fine
    rows ordered by (parity, coarse row): each of the `n_fine` fine rows is
    keyed by the row-major index of its hit (no hit: 8 * N_coarse, group
    8) and sorted stably; binary searches find the group bounds, as in
    ``devox_transpose_table``. Fixed shapes on the device, no host sync."""
    k, n_c = down_kmap.shape
    dev = down_kmap.device
    miss = k * n_c
    flat = down_kmap.reshape(-1).long()
    key = torch.full((n_fine + 1,), miss, dtype=torch.int32, device=dev)
    key.scatter_(0, torch.where(flat >= 0, flat, n_fine),   # misses: a dump
                 torch.arange(miss, dtype=torch.int32, device=dev))
    key, dst = torch.sort(key[:n_fine], stable=True)
    starts = torch.searchsorted(
        key, torch.arange(0, miss + 1, n_c, dtype=torch.int32, device=dev),
        out_int32=True)
    group_off = torch.cat([starts, starts.new_full((1,), n_fine)])
    tiles = (group_off.diff() + tile_rows - 1) // tile_rows
    return ParityPlan(
        src_rows=torch.where(key < miss, key % n_c, -1),
        dst_rows=dst.to(torch.int32), group_offsets=group_off,
        tile_offsets=torch.cat([tiles.new_zeros(1),
                                tiles.cumsum(0, dtype=torch.int32)]),
        tile_rows=tile_rows, max_tiles=-(-n_fine // tile_rows) + k + 1)


def devox_table(idx: torch.Tensor, weights: torch.Tensor, num_voxels: int,
                chunk: int = DEVOX_CHUNK) -> DevoxTable:
    """The devoxelize table of one level: corner indices and weights [8, N]
    (K7), their CSR transpose by voxel and its segments of at most `chunk`
    contributors (K8)."""
    t_ptr, t_point, t_weight = devox_transpose_table(idx, weights,
                                                     num_voxels)
    seg_ptr, seg_voxel = devox_segments(t_ptr, idx.shape[1], chunk)
    return DevoxTable(idx=idx, weights=weights, num_voxels=num_voxels,
                      t_ptr=t_ptr, t_point=t_point, t_weight=t_weight,
                      seg_ptr=seg_ptr, seg_voxel=seg_voxel, chunk=chunk)


def build_pyramid(coords0: torch.Tensor, valid0: torch.Tensor,
                  caps: Sequence[int], *, level0_keys: Keys,
                  devox_levels: Sequence[int] = ()) -> VoxelPyramid:
    """L-level stride-2 pyramid with subm (3^3), down and up kernel maps and
    the devoxelize tables of `devox_levels`. `coords0` is the key-sorted
    deduplicated level-0 table with keys `level0_keys` (VoxelBatch)."""
    num_levels = len(caps)
    levels = [SparseLevel(coords=coords0, valid=valid0, keys=level0_keys,
                          stride=(1, 1, 1))]
    counts = [valid0.sum(dtype=torch.int32)]
    inverses = [None]
    for l in range(1, num_levels):
        prev = levels[-1]
        down = build_downsample(prev.coords, prev.valid, caps[l])
        inverses.append(down.inverse)
        counts.append(down.num_unique)
        levels.append(SparseLevel(coords=down.coords, valid=down.valid,
                                  keys=down.keys,
                                  stride=tuple(2 * s for s in prev.stride)))

    for l, lvl in enumerate(levels):
        lvl.subm_kmap = build_subm_kmap(lvl.keys, lvl.coords, lvl.valid, 3)
        if l >= 1:
            lvl.down_kmap = _updown_from_inverse(levels[l - 1], lvl,
                                                 inverses[l], "down")
            lvl.parity_plan = build_parity_plan(lvl.down_kmap,
                                                levels[l - 1].capacity)
        if l + 1 < num_levels:
            lvl.up_kmap = _updown_from_inverse(lvl, levels[l + 1],
                                               inverses[l + 1], "up")
            lvl.up_one_hot = True

    # the points are the level-0 sites
    l0 = levels[0]
    dev = coords0.device
    point_coords = l0.coords[:, 1:].float()
    iota = torch.arange(caps[0], dtype=torch.int32, device=dev)
    p2v0 = torch.where(l0.valid, iota, torch.full_like(iota, -1))
    points = PointBuffer(coords=point_coords, batch=l0.coords[:, 0],
                         valid=l0.valid)

    # ancestor chain: level-0 row -> its voxel at level l (pure gathers)
    ancestors = [p2v0]
    for l in range(1, num_levels):
        anc = ancestors[-1]
        nxt = inverses[l][anc.clamp(min=0).long()]
        ancestors.append(torch.where(anc >= 0, nxt, torch.full_like(nxt, -1)))

    devox: Dict[int, DevoxTable] = {}
    for l in devox_levels:
        if l == 0:
            devox[0] = DevoxTable(idx=None, weights=None, identity=True)
            continue
        # every point in one level-l cell shares its 8 corner voxels:
        # search once per level-l voxel and spread through the ancestors
        ct = _corner_table(levels[l])
        anc = ancestors[l]
        idx = torch.where(anc[None, :] >= 0, ct[:, anc.clamp(min=0).long()],
                          torch.full((8, anc.shape[0]), -1, dtype=torch.int32,
                                     device=dev)).contiguous()
        w = _devox_weights(point_coords, l0.valid, levels[l].stride,
                           idx).contiguous()
        devox[l] = devox_table(idx, w, caps[l])

    return VoxelPyramid(levels=tuple(levels), points=points,
                        point_to_voxel0=p2v0, devox=devox,
                        level_counts=torch.stack(counts))
