"""Kernel-map construction for sparse convolution.

Counterpart of ``openpcseg_tpu/ops/kmap.py`` (the parts MinkUNet uses). A
kernel map is a dense ``idx[K, N_out]`` int32 array (-1 = miss): for each
output voxel and kernel offset there is at most one input voxel. Each
level stores coords in its own grid units, so downsampling is uniformly
``floor(c / 2)`` and every kernel offset is a unit offset.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from .coords import Keys, UniqueResult, lookup_packed, make_keys, unique_coords

KernelSize = Union[int, Sequence[int]]


def kernel_offsets(kernel_size: KernelSize) -> np.ndarray:
    """[K, 3] integer offsets, row-major over (x, y, z). Odd extents are
    centred {-k//2..k//2}, even extents {0..k-1} (torchsparse convention).
    This order fixes the weight layout [K, Cin, Cout]."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * 3
    axes = [np.arange(-(k // 2), k // 2 + 1) if k % 2 == 1 else np.arange(k)
            for k in kernel_size]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()],
                    axis=1).astype(np.int32)


def _self_z_neighbors(keys: Keys, valid: torch.Tensor):
    """(row of the z-1 neighbour, row of the z+1 neighbour) of every table
    row: in a sorted packed table they are the adjacent rows when present."""
    n = keys.hi.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=valid.device)
    adj_next = (keys.hi[:-1] == keys.hi[1:]) & (keys.lo[:-1] + 1 == keys.lo[1:])
    f = torch.zeros(1, dtype=torch.bool, device=valid.device)
    has_p = torch.cat([adj_next, f]) & valid
    has_m = torch.cat([f, adj_next]) & valid
    miss = torch.full_like(iota, -1)
    return torch.where(has_m, iota - 1, miss), torch.where(has_p, iota + 1, miss)


def build_subm_kmap(level_keys: Keys, coords: torch.Tensor,
                    valid: torch.Tensor, kernel_size: KernelSize = 3
                    ) -> torch.Tensor:
    """Submanifold (stride-1) kernel map idx[K, N] into the same level.

    The centre offset is the identity, the centre column's z+-1 offsets
    come from row adjacency, and every other offset is one searchsorted
    query batch over the packed keys."""
    offs = kernel_offsets(kernel_size)
    n = coords.shape[0]
    dev = coords.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    ident = torch.where(valid, iota, torch.full_like(iota, -1))
    zm, zp = _self_z_neighbors(level_keys, valid)
    centre = {(0, 0, 0): ident, (0, 0, -1): zm, (0, 0, 1): zp}

    rest = [k for k, o in enumerate(offs) if tuple(o) not in centre]
    rows: dict = {k: centre[tuple(o)] for k, o in enumerate(offs)
                  if tuple(o) in centre}
    if rest:
        d = torch.as_tensor(offs[rest], dtype=torch.int32, device=dev)
        q = torch.cat([coords[None, :, :1].expand(len(rest), n, 1),
                       coords[None, :, 1:] + d[:, None, :]], dim=-1)
        qk = make_keys(q, valid[None, :].expand(len(rest), n)).packed()
        found = lookup_packed(level_keys.packed(), qk)
        for i, k in enumerate(rest):
            rows[k] = found[i]
    return torch.stack([rows[k] for k in range(len(offs))])


def build_downsample(coords: torch.Tensor, valid: torch.Tensor, out_cap: int,
                     stride: int = 2) -> UniqueResult:
    """Coords of the next level: unique(floor(c / stride)), key-sorted."""
    down = torch.cat([coords[:, :1], torch.div(coords[:, 1:], stride,
                                               rounding_mode="floor")], dim=1)
    return unique_coords(down, valid, out_cap)
